#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py

Drives ``src/repro_torch`` (never the JAX package) through its serving
path and its ssProp training paths (ResNet-18, the DDPM UNet, qwen2.5-3b,
mamba2-1.3b; qwen2.5-3b also through a checkpoint, a crash and a resume,
and as a 2-rank fleet; on 1x2 and 2x1 device meshes and serving on a
model mesh of 2, a rank a process), the other decoder-only families (mamba2-1.3b and kimi-k2
serving at full width, the reduced configs of the seven archs beside
qwen2.5-3b), the encoder-decoder and VLM families (whisper-large-v3 and
paligemma-3b serving at full width and training at full width and
depth), sharded
selection (ResNet-18 under a TP-sharded selection, grouped convs,
qwen2.5-3b under the JAX dryrun's TP policies, the MoE archs' DP-local
dispatch), and fails (non-zero exit, no result line) on any error:

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
   busy time, the kernels that take most of it), eager and as the engine
   runs them, captured CUDA graphs (``launch/graphs.py``); then the serving CLI on
   the reduced config through both routes, whose greedy token streams
   must be identical; then the reduced fp32 config through the engine
   API: 6 sampled requests on the kernel and the gather route, under swap
   preemption, speculating 4 tokens with a 1-layer drafter (10 verify
   rows a KV head: the 16-row tile), through the contiguous engine and
   the lock-step oracle, every stream identical;
6. serve phase: ``repro_torch.launch.serve.run`` serves 8 Poisson-arriving
   requests (prompt 128, gen 32) through 4 slots of the paged engine at
   full width; every request must get exactly 32 tokens in the
   vocabulary, and the kernel must have launched once per layer per step
   (the engine runs each step as a captured graph, a graph a width: the
   replays count their launches), by its counter and on the device (the
   run under the profiler's device tracing, ``on_device``); the same
   requests through the eager engine (``--no-graphs``), then sampled
   through both (the sampled captured run traced as the greedy one, each
   mode's captured run once more untraced, for the times): the streams equal token for
   token, with each run's p50/p99 step, tokens/s, peak memory, the
   graphs' capture seconds and pool; then ``serve_features_phase``, the
   rest of serving at full width and 3 of the 36 layers (their bf16
   params), then with an fp32 copy: the
   requests sampled (temperature 0.8, top-k 50, top-p 0.95) through the paged
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
   then ``[shard-route]``: the same step (same params and batch) under
   ``tpu_default(0.8)`` with ``tp_shards=2`` on the three routes: the
   same kept channels at every site, as many in each shard, each leaf
   within 1e-4, and the kernel route's launches equal to the route table
   of ``backward_route`` under the sharded selection (the 64- and
   128-channel sites' shard blocks shrink below 128: no ``block_idx``,
   the gathered VJP; the 256- and 512-channel sites keep 128-channel
   blocks: ``conv_dx_fused`` / ``conv_dw_fused`` at 3x3, ``dx_gathered``
   / ``dw_gathered`` at the 1x1 downs); then ``[grouped]``:
   ``sparse_conv2d`` with groups (G=2 at 256 channels, G=4 at 512, G=2
   at 64; B=128, ``tpu_default(0.8)`` at 64-channel blocks,
   ``use_pallas``) on the three routes: each group keeping as many
   channels, the same on every route, dX and dW within 1e-4; the fused
   kernels launched once each at the first two (block-diagonally), none
   at the third (gathered: 64 is not a multiple of 2 x 64); each fused
   kernel against its plain version at the kept blocks, timed beside
   ``conv2d_weight`` / ``conv2d_input`` with ``groups`` and its bound;
8. training phase: ``repro_torch.launch.train_classifier.run`` trains
   ResNet-18 for 8 epoch-bar steps (2 a epoch: steps 2, 3, 6, 7 sparse),
   each step a captured graph (one a drop rate); every loss finite, each
   gathered kernel launched the route table's count times 4,
   ``paged_attention`` not at all, by the counters and on the device (the
   run under the profiler's device tracing: the replays' kernels counted
   where they run; the step times under it); the same run with
   ``--no-graphs``:
   losses, every step's kept channels, params and Adam state bit for bit,
   or, where 3 eager runs part among themselves (cuDNN's default dense
   algorithms), bit for bit under ``cudnn.deterministic``, the kept
   channels an eager run's and the state within twice the eager runs'
   widest pair's distance (``captured_vs_eager``); then a profile of one dense and one
   sparse step, eager and captured, the captured replay's kernels on the
   device those its graph books;
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
   times 4, ``paged_attention`` and ``matmul`` not at all, each step and
   the sampler's denoising step captured; held to the ``--no-graphs`` run
   as in 8, the samples too; the backward FLOPs ledger, block 32 beside
   block 128; then a profile of one dense and one sparse step and of one
   denoising step, eager and captured (12);
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
   depth 2 (PR 30; 4 before), fp32 with TF32 off, through ``matmul``, the gather route and
   the mask oracle: the same kept channels at every site, the same loss,
   every gradient leaf within a relative L2 of 1e-4 between each pair;
   then ``[tp-lm]``: the same step under the JAX dryrun's ``ssprop_tp``
   (``tpu_default(0.8)`` with ``tp_shards=16``) through the TP fast path
   and the mask oracle: the same kept channels, ``k_loc`` in each of the
   16 shards, each leaf within 1e-4, no kernel launched;
15. LM training phase: ``repro_torch.launch.train.run`` trains qwen2.5-3b
   at full width and depth (bf16, B=8, S=128, channel granularity with
   ``--use-pallas``) for 8 epoch-bar steps (steps 2, 3, 6, 7 sparse);
   every loss finite, ``matmul`` launched the launch table's count times
   4, no other kernel, no operand repacked; then a profile of one dense
   and one sparse step, in which the bf16 tensor-core kernel carries all
   504 ``matmul`` launches of the sparse step and the SIMT one none;
   then, on the profile's params and Adam state cut to 6 layers (room
   for the mesh phases), ``[tp-lm]``: each projection's kept
   channels under 16 shards against global selection with
   ``dense_backward_contraction_bounds``, 4 timed
   ``make_train_step`` steps and a profile of ``ssprop_tp`` and of
   ``opt`` (plus a bf16 backward), no kernel launched, and
   ``compress_tree`` at 1 % over one ``ssprop_tp`` step's gradients (its
   time, the bytes against the full gradients', grad == kept + residual
   exactly at every leaf);
15b. fault-tolerant LM training (``[ckpt]``): ``train.run`` on qwen2.5-3b
   at full width, depth cut 36 -> 2 (a save holds ~4.7 GB), bf16, B=8,
   S=128, ``--use-pallas``, 6 steps of 2-step epochs, ``--ckpt-every 3
   --fail-at-step 4``: it saves step 3 (the JAX package's format, written
   on a thread from pinned host copies), crashes once, resumes from 3
   (the restored params, m and v equal to the saved snapshot by sha256),
   replays sparse step 3 through ``matmul`` (launched the launch table's
   count for each of the 3 sparse steps run) and saves step 6; the same
   run twice without checkpoints must agree bit for bit (the step is
   deterministic on the card), and the resumed losses with theirs;
   prints the free space, the bytes a save
   writes, the blocking snapshot time, the write and restore times and
   GB/s. Then ``[fleet]``: two ranks of ``python -m
   repro_torch.launch.train --reduced`` on the one card under
   ``--coord-dir`` / ``--world-size 2`` write a sharded checkpoint (a
   shard a rank, the leader's manifest), and one process resumes from it:
   its losses equal the fleet's after the checkpoint. Then
   ``[fleet-mesh]`` (a fleet on a mesh): two launchers of ``python -m
   repro_torch.launch.train`` (qwen2.5-3b at full width, depth 2, fp32,
   B=2 S=128, ``--use-pallas``) under ``--coord-dir`` / ``--world-size 2``,
   each on a 1x2 mesh (4 processes over gloo on the card; every
   ``matmul`` product of each mesh rank held to the plain version on its
   operands), save every 3 of 6 steps; both fleet checks hold at step
   4's start until the fleet changes, and once step 3 is committed with
   the fleet plan's two shards fleet rank 1's launcher is SIGKILLed: its
   mesh ranks must be gone within 10 s (by ``/proc``; by ``nvidia-smi
   --query-compute-apps`` too where it lists them), rank 0 evicts it at
   step 4, restarts once from step 3 at world 1 (step 6's manifest
   ``ranks == [0]``) and exits 0; beside that restart a world-1 launcher
   on 1x2 resumes from step 3 with rank 0's losses bit for bit;
   each mesh rank's ``matmul`` launches equal the launch table's; steps
   0-2 within 1e-4 of a 1x1 run of the same arguments in this process.
   Its launchers run after 23a, while this process runs 23b-c;
15c. device meshes (``[mesh-train]``, ``[mesh-serve]``): ``train.run``
   on qwen2.5-3b at full width, depth 2, fp32 with TF32 off, B=8 S=128,
   ``paper_default(0.8)`` with ``--use-pallas``, 3 steps (dense, sparse,
   sparse) at 1x1 in this process, and ``serve.run`` at full width,
   depth 3 of 36, fp32 and bf16; then one spawn of two rank processes on the card over
   gloo runs the training CLI's rank body on a 1x2 and a 2x1 mesh: losses
   within 1e-4 relative of 1x1, the share of (step, site) kept sets equal
   to 1x1's, each rank's ``matmul`` launches equal to
   ``kernel_launches_per_step``'s, every one of those launches held to
   the plain version on its own operands (1e-4 x max(1, max|plain|));
   then 3 timed bf16 steps at 1x2 (step ms, each rank's device busy ms,
   the collectives' calls and bytes a step, their ms from a second run
   with each synced), the warm-up step's products checked alike and the
   row-parallel ``layer_0/attn/o`` dY equal bit for bit on both model
   ranks; then the serving CLI's rank body at full width, depth 3, on a
   model mesh of 2 (the serve phase's 8 requests), fp32 and bf16:
   ``paged_attention`` 3 launches a step on each rank, the fp32 share of
   tokens equal to the 1x1 fp32 run's at least 0.9 (bf16's against the
   1x1 bf16 run's, printed), tokens/s and p50/p99; then, in the same
   spawn (``[mesh-data-serve]``), the fp32 config on ``--data-mesh 2``
   (the paged engine, 2 slots a rank, the page pool replicated): each
   rank launches ``paged_attention`` once a layer a step, the two data
   ranks' running pool digests (a checksum a step) are equal, the share
   of tokens equal to the 1x1 fp32 run's at least 0.9; then at depth 2
   the lock-step engine at 1x2, at 2x1 and at 1x2 with
   ``decode_seq_shard`` (the sequence over ``model``), each share at
   least 0.9 against a 1x1 fp32 paged run at that depth; and one lock-step
   decode step at 1x2 and 2x1 counted (each rank's param and cache bytes,
   the collectives' calls and bytes); then (``[mesh-seq]``) the
   training CLI's rank body on 2x1 at depth 2, B=3 S=128, a batch
   ``--data-mesh 2`` does not divide: ``data`` moves to the sequence (64 positions a rank,
   the K/V all-gathered over ``data``), beside a 1x1 run at the same batch
   in this process: losses within 1e-4 relative, the first sparse step's
   kept sets equal at every site, each rank's ``matmul`` launches (counted
   from 0 around the run) equal to the launch table's, every one held to
   the plain version, the sequence split's collectives a step;
16. SSM training: the loss and every gradient leaf of one sparse step of
   mamba2-1.3b at full width and depth 4 (fp32, B=2, S=512) through
   ``matmul``, the gather route and the mask oracle, the same kept
   channels; then ``repro_torch.launch.train.run`` trains mamba2-1.3b at
   full width and depth (48 layers, bf16, B=4, S=512: two 256-token SSD
   chunks) for 8 epoch-bar steps: every loss finite, ``matmul`` launched
   the launch table's 192 times 4, dense and sparse step medians,
   tokens/s and peak memory;
17. SSM serving: mamba2-1.3b at full width, depth cut 48 -> 2, serves 8
   sampled requests (prompt 32, gen 32, 4 slots) through the paged engine, a
   10-page pool (small enough to swap), self-drafted speculation (k=4), the
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
   patches in the batch) and identical sampled streams
   through the paged engine on both routes, swap, speculation with a
   one-period drafter, the contiguous engine and the lock-step oracle;
   then ``[moe-grouped]``: kimi-k2's, llama4-maverick's and jamba's
   reduced configs with ``moe_dp_groups=2`` on the three training routes
   (the same kept channels for every site, expert and group), ``matmul``
   launched the launch table's count (2 x experts x products on the
   expert sites), each MoE layer's ``aux_loss`` and ``dropped`` printed;
20. encdec serving (``[encdec-serve]``): whisper-large-v3 at full width,
   depth cut to 2 encoder + 2 decoder layers of 32 + 32 (d 1280, vocab
   51866), 8
   sampled Poisson requests, each with its ``[1500, 1280]`` frames from
   the workload (prompt 16, gen 64, 4 slots, 16-token pages) through the
   paged engine on the kernel and the gather route, a 12-page pool
   (swaps), self-drafted speculation (k=4), the contiguous engine and
   the lock-step baseline, bf16 and an fp32 copy: ``paged_attention``
   launched at D=64 once a layer a target step, every page back and
   zero, tokens/s, p50/p99 step, the encoder's time a call, peak memory,
   the shares of tokens equal to the paged kernel run's (fp32 at least
   0.9); a profile of a decode and a mixed step;
21. VLM serving (``[vlm-serve]``): paligemma-3b at full width, depth cut
   18 -> 2 (d 2048, d_ff 16384, vocab 257216), the same runs (prompt
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
23. the other families on device meshes (``[mesh-families]``, PR 24):
   ``train.run`` at 1x1 in this process, then one spawn of two rank
   processes on the card over gloo running the training CLI's rank body
   on a 1x2 and a 2x1 mesh, of mamba2-1.3b (depth 1 of 48, B=4 S=512),
   whisper-large-v3 (1 + 1 of 32 + 32 layers, B=2 S=128, 1500 stub
   frames), paligemma-3b (depth 1 of 18, B=8 S=128, 256 stub patches)
   and the reduced kimi-k2, llama4 and jamba at ``moe_dp_groups`` 0 and
   2 (B=8 S=64), all fp32 with TF32 off, ``paper_default(0.8)`` with
   ``--use-pallas``, 3 steps (dense, sparse, sparse): losses within 1e-4
   relative of 1x1, the share of (step, site) kept sets equal to 1x1's (a
   routed expert's own), each rank's ``matmul`` launches equal to the
   launch table's, every one of them within 1e-4 x max(1, max|plain|) of
   the plain version on its own operands; then the serving CLI's rank
   body on ``--model-mesh 2`` (4 Poisson requests, prompt 16, gen 16):
   kimi-k2 at full width and depth 1 in bf16 (192 experts and 4 KV heads
   a rank; its 1x1 tokens from ``[moe-serve]``'s params, freed before the
   spawn), mamba2 at depth 1, whisper at 2 + 2 and paligemma at depth 2
   in fp32 (its one KV head cached on both ranks): each rank's
   ``paged_attention`` launches (an attention layer a step), the fp32
   shares of tokens equal to the 1x1 runs' at least 0.9 (kimi-k2's bf16
   share printed), tokens/s, p50/p99 step and the collectives' calls and
   bytes a step; then ``[mesh-seq]`` in the same spawn: mamba2 (depth 4,
   B=1 S=512: one 256-token SSD chunk a rank, the conv's halo and the
   carried state passed between the ranks), whisper-large-v3 at full width
   (2 + 2 of 32 + 32 layers, 1500 frames, B=1 S=128: 64 tokens a rank, the
   encoder alike on both, the cross-attention's K/V gradient summed over
   ``data``: its calls and bytes a step printed), paligemma-3b at full
   width (2 of 18 layers, 256 patches, B=1 S=128: 128 patches and 64
   tokens a rank, attention masked by position vectors; its three steps
   sparse, ``MF_SEQ_SCHEDULER``) and the reduced
   kimi-k2, llama4 and jamba at ``moe_dp_groups`` 0 and 2 (B=3 S=64) on
   2x1, each beside its 1x1 run, held as in 15c;
23a. model meshes that do not divide the q heads (``[mesh-heads]``):
   whisper-large-v3 at full width, 1 + 1 of 32 + 32 layers, B=2
   S=128 with 1500 stub frames, on ``--model-mesh 8`` (160 of its 1280 q
   columns a rank: each rank runs the 3 heads they touch, the 20 KV heads
   neither dividing 8 nor divided by it), 8 rank processes on the card
   over gloo; the reduced llama4-maverick with 10 q heads on 2 KV heads
   and the reduced paligemma with 2 on 1 (their spans at ``--model-mesh
   16``: 3 q heads on one KV head, half a head) on 4; fp32, TF32 off,
   ``paper_default(0.8)`` with ``--use-pallas``, 3 steps, then serving 4
   Poisson requests (prompt 16, gen 16), each beside its 1x1 run in this
   process: losses within 1e-4 relative, the first sparse step's kept
   sets equal at every site, each rank's ``matmul`` launches equal to the
   launch table's (rank 0's counted from 0 around the run), every one
   within 1e-4 x max(1, max|plain|) of the plain version on its own
   operands, nothing else launched; the share of tokens equal to 1x1's
   1.0, each rank's ``paged_attention`` launches an attention layer a
   step, the collectives a step;
23b. the program auditor on the card (``[audit]``): every kernel
   launch this process made (each distinct set of a launch's integer
   arguments, recorded from the build on by
   ``gathered_matmul.observe_launches``) has its ``<name>_geometry`` report
   (grid, block, dynamic shared memory, split, stages: what its
   ``<name>_launch`` uses) equal to ``kernels/specs.py``'s and passes
   ``analysis/launch_check.py`` under the card's own
   ``shared_memory_per_block_optin``; each kernel's geometry at its largest
   launch, its tile and useful FLOPs and its emulated over least bytes are
   printed; one sparse ResNet-18 step (B=128, ``use_pallas``, block 128)
   one sparse qwen2.5-3b step (full width, depth 4, ``--use-pallas``) and
   one of the reduced kimi-k2 (the MoE dispatch's boolean masks and
   ``bincount`` stall the host), and the steps that run captured (the
   ResNet-18 and DDPM CLIs' in-place steps, qwen2.5-3b's slot step at
   depth 2, greedy and sampled: none may stall the host) run under
   ``torch.cuda.set_sync_debug_mode("warn")``: the warnings
   counted equal the census's host syncs for the same step on meta
   (``analysis/dispatch_walk.py``), and the wrappers' launch counters the
   census's launches; then the savings audits of ResNet-18, the DDPM and
   qwen2.5-3b on the kernel route: the kernels' tile FLOPs against
   ``core/flops.py``'s TPU-tiled count;
23c. the dry run (``[dryrun]``): ``[mesh-train]``'s configuration
   (qwen2.5-3b, depth 2, B=8, S=128) at 1x2 and 2x1 on the fake process
   group (``launch/dryrun.py``, every rank on meta): its per-rank
   parameter and Adam bytes and collective calls and bytes a step equal
   what the 1x2 bf16 ranks recorded, its ``matmul`` launches a rank a
   sparse step the fp32 runs' at both layouts; ``[mesh-data-serve]``'s
   lock-step decode step (depth 2, fp32, B=4, 160 tokens) at 1x2 and
   2x1 on the fake group: each rank's param and cache bytes and the
   collectives' calls and bytes equal what the card's ranks recorded;
   ``[mesh-seq]``'s qwen2.5-3b, whisper and paligemma runs on the fake
   group: the sequence split's collectives a step (whisper's cross K/V
   sums among them) equal rank 0's on the card; qwen2.5-3b x
   ``train_tight`` at full width and depth as rank 0 of 16x16 and
   2x16x16: its block ``[8, 256]`` / ``[4, 256]``, eager peak and
   collectives; then qwen2.5-3b x ``train_4k`` and x ``decode_32k`` on 16x16: each
   rank's argument bytes beside ``torch.cuda.mem_get_info()``'s total,
   and ``decode_32k``'s step run on the fake group (its eager peak), with
   the card's name and power limit; then (``[dryrun] [heads]``) the 10
   cells a model mesh that cuts the q heads opens on 16x16 under
   ``ssprop`` (whisper's, paligemma's and llama4's ``train_4k``,
   ``prefill_32k``, ``decode_32k``, llama4's ``train_tight``), at full
   width and depth 1 (1 + 1; llama4 2: a dense and a MoE layer), rank 0:
   argument bytes (a decode cell's
   state as the port holds it beside the reference's), eager peak,
   collectives; then (``[dryrun] [tight]``) whisper's and paligemma's
   ``train_tight`` on 16x16, rank 0, at the same depths: the batch block
   (whisper's frames whole, paligemma's patch block), arguments, peak,
   collectives a step, the sequence split's and of them the cross K/V
   all-reduce's share;
24. prints the card's line, the kernels' JSON line (``device_launches``
   the captured paths' counts as the device ran them: ResNet-18's and the
   DDPM's, ``[serve]``'s; a gathered kernel's ``launches`` is the sum of
   the ResNet-18 and DDPM training phases'
   and the kernel routes of ``[shard-route]`` and ``[grouped]`` (the
   fused kernels' ``grouped`` key holding the G=2 case's times),
   ``paged_attention``'s the serve phase's, the paged runs' of
   ``serve_features_phase``, the kimi-k2, whisper and paligemma serve
   phases', ``matmul``'s the qwen2.5-3b, mamba2-1.3b, whisper and
   paligemma training phases', the resumed run's of ``[ckpt]``
   (``lm_resume``), ``[moe-grouped]``'s kernel routes and every rank's
   of ``[mesh-train]`` (``mesh_train``; ``paged_attention``'s
   ``mesh_serve``, and ``mesh_data_serve`` the ``--data-mesh 2`` run's)
   and of ``[mesh-families]`` (``mesh_families``, the 1x1
   runs' and every rank's), of ``[mesh-seq]`` (``mesh_seq``, the 1x1
   runs' and every rank's) and of ``[mesh-heads]`` (``mesh_heads``,
   likewise, ``paged_attention``'s too), each in
   ``launches_by_path``, with the
   verify chunk's times in ``verify``, kimi-k2's decode in ``d112``,
   whisper's in ``d64`` and paligemma's in ``d256``; ``matmul``'s
   ``max_abs_err`` covers the qwen2.5-3b, whisper and paligemma products
   and the mesh ranks', the latter three also in ``by_arch``; its times are at the ResNet
   path's largest shape, the DDPM path's in ``ddpm``) and,
   last, the device JSON line.
"""
from __future__ import annotations

import ast
import atexit
import collections
import dataclasses
import gc
import hashlib
import itertools
import json
import math
import os
from pathlib import Path
import shutil
import subprocess
import sys
import threading
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
EAGER_DRAWS = 3  # eager runs a captured CNN run is held to where they part
LM_ARCH, LM_BATCH, LM_SEQ, LM_RATE = "qwen2.5-3b", 8, 128, 0.8
LM_ROUTE_DEPTH = 2  # the route check's depth (full width; PR 30: 4 before)
# [serve-features]: the serving modes at 3 of qwen2.5-3b's 36 layers (the
# [serve] main path runs them all); the script must end well inside 1200 s
SERVE_FEATURES_DEPTH = 3
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

# each wrapper's kernel as the profiler names it on the device: one a
# launch (a launch's second kernel, a split's reduce or combine, is not
# the wrapper's count)
DEVICE_KERNELS = {
    "dx_gathered": ("dx_gathered_kernel",),
    "dw_gathered": ("dw_gathered_kernel",),
    "conv_dw_fused": ("conv_dw_fused_kernel",),
    "conv_dx_fused": ("conv_dx_fused_kernel",),
    "matmul": ("matmul_wgmma_kernel", "matmul_simt_kernel"),
    "importance": ("importance_kernel",),
    "paged_attention": ("paged_attn_simt", "paged_attn_mma"),
}


def device_launches(counts) -> dict[str, int]:
    """Each wrapper's kernel launches among device kernels (``(name,
    count)`` pairs), by :data:`DEVICE_KERNELS`."""
    out = dict.fromkeys(DEVICE_KERNELS, 0)
    for key, n in counts:
        for name, marks in DEVICE_KERNELS.items():
            if any(m in key for m in marks):
                out[name] += n
    return out


def on_device(fn):
    """``fn()`` under the profiler's device tracing: its result and the
    wrappers' kernels that ran on the device (:func:`device_launches`).
    A captured graph's kernels are counted where each replay runs them,
    not where its launch counters were bookkept. The trace's events are
    counted by name as they come (a run's hundreds of thousands of them:
    ``key_averages`` would take minutes)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    names = collections.Counter(e.name() for e in prof.profiler.kineto_results.events()
                                if e.device_type() == DeviceType.CUDA)
    return out, device_launches(names.items())


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
    """Least time for the work this input needs, from the launch's
    ``kernels/specs.py`` spec given the query positions: each needed K/V
    page read once, q/tables/qpos read once, the fp32 output written once;
    QK and PV at 2 flops a multiply-add over the visible keys, in fp32 at
    the FMA rate, or, given ``tf32_terms = (qk, pv)``, as that many TF32
    products of each at the tensor cores' rate (the 64-row variant's
    arithmetic)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import specs

    b, s, h, d = q.shape
    n_pages, bs, kv, _ = k.shape
    nb = tables.shape[1]
    plan = pa.paged_split_plan(b, s, h, kv, d, nb, bs)
    spec = specs.paged_attention_spec(
        b, s, h, kv, d, n_pages, bs, nb, plan.row_tile, plan.chunk, plan.splits,
        int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16), qpos=qpos.tolist())
    flops = spec.useful_flops
    t_bytes, t_ops = spec.least_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
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


def serve_captured_vs_eager(serve, cfg, params, argv, cap, pa):
    """The serve phase's 8 requests through the captured paged engine
    (``cap``, the counted run: a graph a width, greedy, under the
    profiler's device tracing) against the eager engine on the same
    params, token for token; then the same requests sampled
    (:data:`SAMPLED`), captured (traced: its kernels on the device must be
    its counter's, as ``cap``'s were) against eager. Each mode runs
    captured once more untraced, for the times the eager run's compare
    with (the tracing slows a step; an eager run's launches are counted
    where they are made). In every run ``paged_attention`` launches once
    a layer a step by its counter (a replay adds its graph's launches)
    and the streams are the same. Prints each untraced run's p50 step,
    tokens/s and peak memory, and the graphs' capture seconds and pool
    bytes."""
    if not cap["captured"]:
        raise AssertionError("[serve] the paged engine did not capture its steps")
    ap = serve.build_parser()
    sampled = ["--temperature", str(SAMPLED["temperature"]), "--top-k", str(SAMPLED["top_k"]),
               "--top-p", str(SAMPLED["top_p"])]
    runs, traced = {}, {"greedy": cap}
    for mode, extra, graphs, trace in (("greedy", [], True, False), ("greedy", [], False, False),
                                       ("sampled", sampled, True, True),
                                       ("sampled", sampled, True, False),
                                       ("sampled", sampled, False, False)):
        args = ap.parse_args(argv + extra + ([] if graphs else ["--no-graphs"]))
        torch.cuda.reset_peak_memory_stats()
        before = pa.launches
        if trace:
            out, seen = on_device(lambda: serve.serve_rank(None, args, cfg, params=params))
        else:
            out, seen = serve.serve_rank(None, args, cfg, params=params), None
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        out["launches"] = pa.launches - before
        if (out["launches"] != cfg.n_layers * out["steps"] or out["captured"] != graphs
                or (trace and seen["paged_attention"] != out["launches"])):
            raise AssertionError(f"[serve] {mode} captured={graphs}: launches {out['launches']} "
                                 f"!= {cfg.n_layers} x {out['steps']} steps or != the device's "
                                 f"{seen and seen['paged_attention']}, or captured "
                                 f"{out['captured']}")
        if trace:
            traced[mode] = out
        else:
            runs[(mode, graphs)] = out
    for mode, t in traced.items():
        if not np.array_equal(t["generated"], runs[(mode, True)]["generated"]):
            raise AssertionError(f"[serve] {mode}: the traced captured run's streams differ")
    summary = {}
    for mode in ("greedy", "sampled"):
        c, e = runs[(mode, True)], runs[(mode, False)]
        if not np.array_equal(c["generated"], e["generated"]):
            share = float((c["generated"] == e["generated"]).mean())
            raise AssertionError(f"[serve] {mode}: captured streams != eager ({share:.3f} of "
                                 "tokens equal)")
        row = {}
        for name, o in (("captured", c), ("eager", e)):
            ms = np.asarray(o["step_times"]) * 1e3
            row[name] = dict(steps=o["steps"], p50_ms=float(np.percentile(ms, 50)),
                             p99_ms=float(np.percentile(ms, 99)),
                             tokens_per_s=o["stats"]["tokens_per_s"],
                             peak_gib=o["peak_bytes"] / 2**30)
        g = c["graphs"]
        row["graphs"] = dict(keys=g["keys"], capture_s=g["capture_s"], replays=g["replays"],
                             pool_gib=g["pool_bytes"] / 2**30)
        summary[mode] = row
        print(f"[serve] {mode}: captured streams = eager, token for token ({c['generated'].size} "
              f"tokens); step p50 captured {row['captured']['p50_ms']:.2f} ms / eager "
              f"{row['eager']['p50_ms']:.2f} ms, p99 {row['captured']['p99_ms']:.2f} / "
              f"{row['eager']['p99_ms']:.2f} ms, tokens/s {row['captured']['tokens_per_s']:.1f} / "
              f"{row['eager']['tokens_per_s']:.1f}; peak memory {row['captured']['peak_gib']:.2f}"
              f" / {row['eager']['peak_gib']:.2f} GiB; graphs {g['keys']} captured in "
              f"{g['capture_s']:.2f} s, pool {row['graphs']['pool_gib']:.3f} GiB", flush=True)
    return summary


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
    """The rest of serving at full width, depth ``SERVE_FEATURES_DEPTH``
    (qwen2.5-3b, the serve phase's bf16 params' first layers, fp32
    caches): 8 sampled requests (temperature
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
    activations otherwise, layers of random weights grow that into
    logits a few percent apart (``route_check``), and a sampled stream
    leaves the other at the first draw that flips: the bf16 shares are
    printed as measured. In fp32 the runs differ in summation order only,
    and every share must reach SHARE_MIN. Returns the launches of the
    paged runs, the summaries by precision and the verify step's plan."""
    cfg = dataclasses.replace(cfg, n_layers=SERVE_FEATURES_DEPTH)
    params = dict(params, stack=dict(params["stack"],
                                     layers=params["stack"]["layers"][:SERVE_FEATURES_DEPTH]))
    print(f"[serve-features] {cfg.name} full width, depth {cfg.n_layers}")
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


def step_profile(cfg, lm, params, dev="cuda", tag="[profile]", enc_out=None, captured=False):
    """Where one step of the main path spends its time: a decode step
    (4 slots, 1 token each) and a mixed step (two prefill chunks of 32,
    two decodes) at 10 pages a slot through the kernel route (``enc_out``:
    the slots' encoder outputs, encdec). Host wall time per step over 5
    runs, then one profiled run: device busy time and the kernels that
    take most of it. ``captured``: the same two steps as the engine runs
    them, the slot step captured as a CUDA graph
    (``launch/graphs.py``), measured alike beside the eager ones."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import steps as lm_steps
    from repro_torch.launch.graphs import StepGraphs

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev == "cuda" else [])
    gen = torch.Generator(device=dev).manual_seed(2)
    b, bs, nb = 4, 16, 10
    cache = lm.init_paged_cache(cfg, b * nb, bs, dtype=torch.float32, device=dev)
    tables = torch.arange(b * nb, dtype=torch.int32, device=dev).reshape(b, nb)
    slot_step = lm_steps.make_slot_step(cfg)

    def measure(label, run, c, booked=None):
        run()
        t0 = time.perf_counter()
        for _ in range(5):
            run()
        wall_ms = (time.perf_counter() - t0) / 5 * 1e3
        with profile(activities=acts) as prof:
            run()
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        print(f"{tag} {label} step (B={b} C={c} NB={nb}): host wall {wall_ms:.3f} ms, "
              f"device busy {busy_ms:.3f} ms in {sum(e.count for e in kernels)} kernels")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"{tag}   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")
        if booked is not None:
            replay_launches(tag, label, kernels, booked())
        return dict(wall_ms=wall_ms, busy_ms=busy_ms)

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

        out[name] = measure(name, run, c)
        if not captured:
            continue
        sg = StepGraphs(lambda _, t, p, n, tb: slot_step(params, {
            "tokens": t, "count": n, "pos": p, "cache": cache, "block_tables": tb})[0], dev)
        out[f"{name}_captured"] = measure(
            f"{name} captured", lambda: sg(name, tokens, pos_t, cnt_t, tables).cpu(), c,
            lambda: sg.graphs[name].launches)
        out[f"{name}_captured"].update(capture_s=sg.stats()["capture_s"],
                                       pool_bytes=sg.stats()["pool_bytes"])
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
    from repro_torch.kernels import specs

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
    dg = d // groups  # the reduction of one output channel: (C_in / G) * k * k
    splits = {  # the split-K of the tensor-core kernels' plans
        "dw_gathered": lambda: gm.dw_plan(m, d, kb, bs, c_out)[0],
        "conv_dw_fused": lambda: gm.conv_dw_plan(m, dg, kb, bs, c_out)[0],
    }
    # the launch's integer arguments (kernels/specs.py LAUNCH_ARGS), for its spec
    bf16, c_pad, cg = int(dtype == torch.bfloat16), nb * bs, c_in // groups
    if name == "dx_gathered":
        ints = (m, c_out, d, kb, bs, bf16)
    elif name == "dw_gathered":
        ints = (m, d, c_out, kb, bs, *gm.dw_plan(m, d, kb, bs, c_out), bf16)
    elif name == "conv_dw_fused":
        ints = (batch, h_in + 2 * pad, groups, h_in + 2 * pad, cg, h_out, h_out, c_pad, c_out,
                k, k, stride, stride, 1, 1, kb, bs, *gm.conv_dw_plan(m, dg, kb, bs, c_out), bf16)
    else:
        ints = (batch, h_in, h_in, pad, pad, groups, cg, h_out, h_out, c_pad, c_out, k, k,
                stride, stride, 1, 1, kb, bs, bf16)
    spec = specs.spec_for_launch(name, ints, block_idx=blocks)
    return dict(
        kernel=lambda *a: getattr(gm, name)(*a, **kw),
        plain=lambda *a: getattr(gm, f"{name}_ref")(*a, **plain_kw),
        args=args, library=lib, lib_args=lib_args, blocks=blocks, spec=spec,
        dims=dict(m=m, d=dg, k_real=len(real), kb=kb, bs=bs, c_in=c_in, h=h_in,
                  h_pad=h_in + 2 * pad, batch=batch, itemsize=args[0].element_size()),
        splits=splits[name]() if name in splits else None,
    )


def gathered_bound_ms(spec, flops_per_s=FP32_FLOPS, passes=1) -> tuple[float, str]:
    """Least time for the work of one launch, from its ``kernels/specs.py``
    spec: its least bytes (each input the function needs read once, the
    kept channels of dY and W only; each output written once in fp32)
    over the memory rate; its useful FLOPs (2 a multiply-add over the real
    kept channels) at the fp32 FMA rate (the SIMT kernels compute in fp32
    whatever the operand type), or ``passes`` products at another unit's
    rate (3xTF32: three TF32 products at the tensor cores' 495 TFLOP/s)."""
    t_bytes = spec.least_bytes / HBM_BYTES_PER_S
    t_ops = passes * spec.useful_flops / flops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _check_close(name, out, ref, what) -> float:
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    limit = KERNEL_TOL * max(1.0, ref.abs().max().item())
    if not (out.dtype == torch.float32 and out.shape == ref.shape and err <= limit):
        raise AssertionError(f"{name} {what}: max|kernel - plain| {err} > {limit} "
                             f"({out.dtype}, {tuple(out.shape)} vs {tuple(ref.shape)})")
    return err


def kernel_rows(gm, ops, launches, gen, tag, *, bs=128, batch=TRAIN_BATCH, groups=1,
                blocks=None):
    """Each ``(kernel, geometry)`` of a launch table against its plain
    version, fp32 and bf16, repeated bit for bit; times, the library call
    and the bounds at fp32. ``groups`` and ``blocks`` (geometry -> kept
    blocks) go to :func:`gathered_case`. Returns the rows, the max abs
    error of each kernel and a sha256 of each kernel's outputs in launch
    order."""
    rows, max_err = [], dict.fromkeys(GATHERED, 0.0)
    digests = {name: hashlib.sha256() for name in GATHERED}
    for (name, geo), count in launches.items():
        for dtype in (torch.float32, torch.bfloat16):
            case = gathered_case(gm, ops, name, geo, dtype, gen, bs=bs, batch=batch,
                                 groups=groups, blocks=(blocks or {}).get(geo))
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
            fma_ms, _ = gathered_bound_ms(case["spec"])
            bound_ms, bound_by = gathered_bound_ms(case["spec"], TF32_FLOPS, passes=3)
            c_in, c_out, k, h_in, stride, kb = geo
            flops = 2 * case["dims"]["m"] * case["dims"]["d"] * case["dims"]["k_real"]
            row = dict(name=name, shape=f"B={batch} C_in={c_in} C_out={c_out} k={k} H={h_in} "
                       f"stride={stride}" + (f" groups={groups}" if groups > 1 else "")
                       + f" bs={bs} KB={kb} blocks={case['blocks']}",
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


def _resnet_sites(params) -> dict:
    """Weight pointer -> ResNet-18 site name."""
    site_of = {params["stem"]["w"].data_ptr(): "stem"}
    for bi, blk in enumerate(params["blocks"]):
        for key, site in (("conv1", "conv1"), ("conv2", "conv2"), ("down_conv", "down")):
            if key in blk:
                site_of[blk[key]["w"].data_ptr()] = f"block_{bi}/{site}"
    return site_of


def training_route_check(tc, resnet, backward, policy_mod, pipeline):
    """The loss and all parameter gradients of one sparse step (0.8) of
    the full-width ResNet-18 three ways: through the kernels, the gather
    route (the conv VJP on the kept filters) and the mask oracle. All
    fp32 with TF32 off, so the routes differ in summation order only.
    Returns the worst relative L2s, and the params and batch for
    :func:`shard_route_phase`."""
    params = resnet.init_params(RESNET, 0, 10, device="cuda")
    x, y = training_batch(pipeline)
    kern = train_policy(policy_mod)
    routes = {"kernels": kern, "gather": dataclasses.replace(kern, use_pallas=False),
              "mask": dataclasses.replace(kern, use_pallas=False, mask_mode=True)}
    site_of = _resnet_sites(params)
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
    return worst, (params, x, y)


# ----------------------------------------------------------------------
# sharded selection: TP-balanced blocks and grouped convs on the kernels
# ----------------------------------------------------------------------

SHARD_TP = 2  # [shard-route]: the TP degree of ResNet-18's selection
GROUPED_BS = 64  # [grouped]: the block size (128 would leave one block a group)
GROUPED_CASES = [  # x, w, groups: fused, fused, gathered (64 is not a multiple of 2 x 64)
    ((128, 256, 8, 8), (256, 128, 3, 3), 2),
    ((128, 512, 4, 4), (512, 128, 3, 3), 4),
    ((128, 64, 32, 32), (64, 32, 3, 3), 2),
]


def _compare_routes(res, tag) -> dict:
    """``res[route] = (loss, [(path, grad)], {site: Selection})``: the same
    loss and kept channels on every route, every leaf within
    TRAIN_ROUTE_TOL (relative L2) of the others'. Returns the worst
    relative L2 of each pair."""
    names = list(res)
    worst = {}
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            if abs(res[a][0] - res[b][0]) > TRAIN_ROUTE_TOL * abs(res[b][0]):
                raise AssertionError(f"{tag} loss {a} {res[a][0]} != {b} {res[b][0]}")
            if sorted(res[a][2]) != sorted(res[b][2]):
                raise AssertionError(f"{tag} {a} vs {b}: selections at different sites")
            flips = [k for k in res[a][2] if not torch.equal(res[a][2][k].idx, res[b][2][k].idx)]
            bad, top = [], 0.0
            for (path, ga), (_, gb) in zip(res[a][1], res[b][1], strict=True):
                n = gb.float().norm().item()
                rel = (ga.float() - gb.float()).norm().item() / n if n > 0 else ga.norm().item()
                top = max(top, rel)
                if rel > TRAIN_ROUTE_TOL:
                    bad.append(f"{path} {rel:.3e}")
            worst[f"{a}_vs_{b}"] = top
            if flips or bad:
                raise AssertionError(f"{tag} {a} vs {b}: selection differs at {flips[:5]}; "
                                     f"leaves over {TRAIN_ROUTE_TOL}: {bad[:5]}")
    return worst


def _balanced(sel, c, shards, tag) -> list[int]:
    """Kept channels in each of ``shards`` contiguous groups; all equal."""
    per = torch.bincount(sel.idx // (c // shards), minlength=shards).tolist()
    if len(set(per)) != 1 or sum(per) != sel.k:
        raise AssertionError(f"{tag} unbalanced selection: {per} a shard")
    return per


def shard_route_phase(tc, resnet, backward, sparsity, policy_mod, gm, params, x, y):
    """``[shard-route]``: one sparse step of the full-width ResNet-18
    (B=128, 3x32x32, the params and batch of the training-route check)
    under ``tpu_default(0.8)`` with ``tp_shards=2`` through the kernels,
    the gather route and the mask oracle: the same kept channels at
    every site, the same number in each shard, every leaf within
    TRAIN_ROUTE_TOL, and the kernel route's launches equal to the route
    table's (``backward_route`` under the sharded selection: a site whose
    shard block shrank below 128 carries no ``block_idx`` and takes the
    gathered VJP). Returns the worst relative L2s and the launches."""
    t0 = time.perf_counter()
    kern = dataclasses.replace(train_policy(policy_mod), tp_shards=SHARD_TP)
    routes = {"kernels": kern, "gather": dataclasses.replace(kern, use_pallas=False),
              "mask": dataclasses.replace(kern, use_pallas=False, mask_mode=True)}
    site_of = _resnet_sites(params)
    res, launches = {}, {}
    for name, pol in routes.items():
        before = dict(gm.launches)
        with backward.record_selections() as log:
            loss, grads = tc.value_and_grad(RESNET, params, x, y, pol)
        torch.cuda.synchronize()
        launched = {k: gm.launches[k] - before[k] for k in before}
        if name == "kernels":
            launches = launched
        elif any(launched.values()):
            raise AssertionError(f"[shard-route] the {name} route launched {launched}")
        res[name] = (loss.item(), _named_leaves(grads), {site_of[p]: s for p, s in log})
        del grads
    expect = resnet.kernel_launches_per_step(RESNET, TRAIN_BATCH, TRAIN_IMAGE, kern)
    if launches != {**dict.fromkeys(launches, 0), **expect}:
        raise AssertionError(f"[shard-route] launches {launches} != the route table's {expect}")
    table = resnet.backward_routes(RESNET, TRAIN_BATCH, TRAIN_IMAGE, kern)
    unsharded = dataclasses.replace(kern, tp_shards=0)
    for site, _, c_out, _, _, _ in resnet.iter_conv_shapes(RESNET, TRAIN_IMAGE):
        sel = res["kernels"][2][site]
        per = _balanced(sel, c_out, SHARD_TP, f"[shard-route] {site}")
        _, bs_loc = sparsity.shard_select_width(c_out, kern, SHARD_TP)
        blocks = None if sel.block_idx is None else sel.block_idx.tolist()
        if (blocks is None) != (table[site] == "gathered"):
            raise AssertionError(f"[shard-route] {site}: block_idx {blocks}, route {table[site]}")
        print(f"[shard-route] {site:15s} C_out={c_out}: shard block {bs_loc}, kept {sel.k} "
              f"({per} a shard; unsharded {min(c_out, unsharded.keep_count(c_out) * 128)}), "
              f"block_idx {blocks}, route {table[site]}")
    worst = _compare_routes(res, "[shard-route]")
    print(f"[shard-route] {RESNET} full width, B={TRAIN_BATCH}, tp_shards={SHARD_TP}, one sparse "
          f"step: loss {res['kernels'][0]:.6f}; the same kept channels at all "
          f"{len(res['kernels'][2])} sites, balanced; {len(res['kernels'][1])} leaves, worst "
          "relative L2 " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f" (limit {TRAIN_ROUTE_TOL}); launches {expect} = the route table's; "
          f"{time.perf_counter() - t0:.1f} s")
    return worst, launches


def grouped_phase(gm, ops, conv, backward, policy_mod):
    """``[grouped]``: ``sparse_conv2d`` with ``groups`` under
    ``tpu_default(0.8)`` at 64-channel blocks with ``use_pallas``, at the
    three GROUPED_CASES, through the kernels, the gather route and the
    mask oracle: each group keeps as many channels as the others, the
    same on every route, dX and dW within TRAIN_ROUTE_TOL. The kernel
    route launches ``conv_dx_fused`` and ``conv_dw_fused`` once each where
    ``backward_route`` says "fused" and nothing where it says
    "gathered". Then each fused kernel against its plain version at the
    kept blocks (fp32 and bf16, repeated bit for bit) with its time, the
    library's (``conv2d_weight`` / ``conv2d_input`` with ``groups`` on the
    kept filters) and its bound. Returns the launches, the kernel rows and
    the worst errors."""
    t0 = time.perf_counter()
    kern = dataclasses.replace(policy_mod.tpu_default(0.8), block_size=GROUPED_BS,
                               use_pallas=True)
    routes = {"kernels": kern, "gather": dataclasses.replace(kern, use_pallas=False),
              "mask": dataclasses.replace(kern, use_pallas=False, mask_mode=True)}
    gen = torch.Generator(device="cuda").manual_seed(13)
    total = dict.fromkeys(GATHERED, 0)
    rows, max_err = [], dict.fromkeys(GATHERED, 0.0)
    for x_shape, w_shape, groups in GROUPED_CASES:
        b, c_in, h, _ = x_shape
        c_out, k = w_shape[0], w_shape[2]
        tag = f"[grouped] x{list(x_shape)} w{list(w_shape)} G={groups}"
        route = conv.backward_route(kern, batch=b, h_out=h, w_out=h, c_in=c_in, c_out=c_out,
                                    kh=k, kw=k, groups=groups)
        x = torch.randn(x_shape, generator=gen, device="cuda")
        w = torch.randn(w_shape, generator=gen, device="cuda") / math.sqrt(w_shape[1] * k * k)
        res = {}
        for name, pol in routes.items():
            xt, wt = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
            before = dict(gm.launches)
            with backward.record_selections() as log:
                loss = 0.5 * (conv.sparse_conv2d(xt, wt, padding=k // 2, groups=groups,
                                                 policy=pol) ** 2).mean()
                loss.backward()
            torch.cuda.synchronize()
            launched = {n: c for n in before if (c := gm.launches[n] - before[n])}
            want = ({"conv_dx_fused": 1, "conv_dw_fused": 1}
                    if name == "kernels" and route == "fused" else {})
            if launched != want:
                raise AssertionError(f"{tag} {name} route ({route}) launched {launched} != {want}")
            for n, c in launched.items():
                total[n] += c
            if name == "kernels":
                kernel_launched = launched
            res[name] = (loss.item(), [("dx", xt.grad), ("dw", wt.grad)], {"conv": log[0][1]})
        sel = res["kernels"][2]["conv"]
        per = _balanced(sel, c_out, groups, tag)
        worst = _compare_routes(res, tag)
        blocks = None if sel.block_idx is None else sel.block_idx.tolist()
        print(f"{tag}: route {route}, kept {sel.k}/{c_out} ({per} a group), block_idx {blocks}; "
              "worst relative L2 " + ", ".join(f"{n} {v:.3e}" for n, v in worst.items())
              + f"; kernel route's launches {kernel_launched}")
        if route == "fused":
            geo = (c_in, c_out, k, h, 1, len(blocks))
            r, e, _ = kernel_rows(gm, ops, {("conv_dw_fused", geo): 1, ("conv_dx_fused", geo): 1},
                                  gen, "[grouped]", bs=GROUPED_BS, batch=b, groups=groups,
                                  blocks={geo: blocks})
            rows += r
            max_err = {n: max(max_err[n], e[n]) for n in max_err}
        del x, w, res
    print(f"[grouped] {len(GROUPED_CASES)} cases, launches {total}; max abs err {max_err}; "
          f"{time.perf_counter() - t0:.1f} s")
    return total, rows, max_err


def counted_cnn_run(tag, cli, argv, gm, pa, per_step, batch):
    """One counted run of a CNN training CLI: the launch counts set to 0
    just before ``cli.run`` and read just after. 8 epoch-bar steps (2, 3,
    6, 7 sparse) with finite losses, each gathered kernel launched
    ``per_step`` times a sparse step and no other kernel (``matmul``,
    ``paged_attention``), by the launch counters and on the device (the
    run under the profiler's device tracing, :func:`on_device`: the
    captured steps' replays counted where they run). Prints the step
    times; returns the run's result, the launches and the dense and
    sparse step medians with the device's counts (``device_launches``)."""
    args = cli.build_parser().parse_args(argv)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pa_before = pa.launches
    for k in gm.launches:
        gm.launches[k] = 0
    t0 = time.perf_counter()
    out, seen = on_device(lambda: cli.run(args))
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
    if seen != {**launches, "paged_attention": 0}:
        raise AssertionError(f"{tag} kernels on the device {seen} != the counters {launches}")
    ms = [t * 1e3 for t in rec["step_times"]]
    med = lambda v: (v[len(v) // 2 - 1] + v[len(v) // 2]) / 2  # noqa: E731
    dense_ms = med(sorted(ms[i] for i in range(8) if i not in sparse))
    sparse_ms = med(sorted(ms[i] for i in sparse))
    print(f"{tag} 8 steps in {wall:.2f} s; losses {[round(v, 4) for v in rec['losses']]}")
    print(f"{tag} step ms {[round(v, 2) for v in ms]}; dense median {dense_ms:.2f} ms "
          f"({batch / dense_ms * 1e3:.0f} images/s), sparse median {sparse_ms:.2f} ms "
          f"({batch / sparse_ms * 1e3:.0f} images/s); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches} = "
          f"{per_step} x 4, the device ran as many (step times under its tracing)")
    return out, launches, dict(dense_ms=dense_ms, sparse_ms=sparse_ms, device_launches=seen)


def _state_leaves(rec):
    from repro_torch.optim import adam

    params, opt = rec["state"]
    return adam.tree_leaves((params, opt.m, opt.v))


def _same_run(a, b) -> bool:
    """Two CLI runs' ``ssprop`` records equal bit for bit: losses, every
    step's kept channels, params and Adam state."""
    return (a["losses"] == b["losses"]
            and all(np.array_equal(x, y) for x, y in zip(a["kept"], b["kept"], strict=True))
            and all(torch.equal(x, y) for x, y in zip(_state_leaves(a), _state_leaves(b),
                                                      strict=True)))


def _max_state_diff(a, b) -> float:
    return max(float((x.float() - y.float()).abs().max()) if x.numel() else 0.0
               for x, y in zip(_state_leaves(a), _state_leaves(b), strict=True))


def captured_vs_eager(tag, train, argv, cap):
    """The CLI run ``cap`` (captured: a graph a drop rate) against the
    same training with ``--no-graphs`` from the same init (``train(argv)``:
    the CLI's training): losses, every step's kept channels, the final
    params and Adam state bit for bit. Where they part and
    :data:`EAGER_DRAWS` eager runs part among themselves too (cuDNN's
    default algorithms for the dense convs are not deterministic), a
    captured and an eager run under ``cudnn.deterministic`` must agree bit
    for bit, the captured run's kept channels must be an eager run's at
    every step, and its distance to the nearest eager run (max |d| over
    the state) at most twice the eager runs' widest pair's (the spread
    of the eager runs, of which one pair's distance is a draw that ranged
    over 1.8e-7 to 4.5e-6 on the DDPM). Returns the summary (the eager run's step times beside the captured
    run's, which ran under the profiler's device tracing)."""
    if not cap["captured"]:
        raise AssertionError(f"{tag} the run did not capture its steps")
    runs = [train(argv + ["--no-graphs"])]
    if runs[0]["captured"]:
        raise AssertionError(f"{tag} --no-graphs captured")
    rc = cap["modes"]["ssprop"]
    re_ = runs[0]["modes"]["ssprop"]
    verdict = "bit for bit"
    if not _same_run(rc, re_):
        runs += [train(argv + ["--no-graphs"]) for _ in range(EAGER_DRAWS - 1)]
        eager = [r["modes"]["ssprop"] for r in runs]
        if all(_same_run(re_, e) for e in eager[1:]):
            raise AssertionError(f"{tag} captured run != eager run, and {EAGER_DRAWS} eager runs "
                                 f"agree: losses {rc['losses']} vs {re_['losses']}")
        torch.backends.cudnn.deterministic = True
        try:
            det = [train(argv + [g]) for g in ("--graphs", "--no-graphs")]
        finally:
            torch.backends.cudnn.deterministic = False
        if not det[0]["captured"] or not _same_run(*(d["modes"]["ssprop"] for d in det)):
            raise AssertionError(f"{tag} under cudnn.deterministic the captured run != eager")
        spread = max(_max_state_diff(a, b) for a, b in itertools.combinations(eager, 2))
        got = min(_max_state_diff(rc, e) for e in eager)
        kept_ok = all(any(np.array_equal(x, e["kept"][i]) for e in eager)
                      for i, x in enumerate(rc["kept"]))
        if got > 2 * spread or not kept_ok:
            raise AssertionError(f"{tag} captured vs the nearest eager run max |d state| "
                                 f"{got:.3e} > 2 x the eager runs' widest pair's {spread:.3e}, "
                                 f"or kept channels differ ({kept_ok})")
        verdict = (f"bit for bit under cudnn.deterministic; with cuDNN's default (not "
                   f"deterministic) algorithms the kept channels an eager run's at every step "
                   f"and max |d state| {got:.3e} to the nearest of {EAGER_DRAWS} eager runs, "
                   f"whose widest pair is {spread:.3e} apart")
    ms = lambda rec: [round(t * 1e3, 2) for t in rec["step_times"]]  # noqa: E731
    g = rc["graphs"]
    print(f"{tag} captured vs eager from the same init: losses, kept channels at every step, "
          f"params and Adam state {verdict}; step ms "
          f"captured {ms(rc)} eager {ms(re_)}; graphs {g['keys']} captured in "
          f"{g['capture_s']:.2f} s, {g['replays']} replays, pool {g['pool_bytes'] / 2**20:.1f} "
          f"MiB", flush=True)
    return dict(verdict=verdict, eager_step_ms=ms(re_), captured_step_ms=ms(rc),
                capture_s=g["capture_s"], pool_bytes=g["pool_bytes"], eager_runs=len(runs))


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
    meds["captured"] = captured_vs_eager(
        "[train]", lambda a: tc.run(tc.build_parser().parse_args(a)), argv, out)
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


def captured_profile(tag, name, fn, key, inputs):
    """:func:`profile_step` of ``fn`` (a CLI's in-place step) captured as a
    graph at ``key`` (``launch/graphs.py``): the warm-up call runs the
    step and captures it, the timed and profiled calls replay. The
    profiled replay's kernels on the device must be the launches the
    graph books a replay. Returns (wall_ms, busy_ms, capture_s,
    pool_bytes)."""
    from repro_torch.launch.graphs import StepGraphs

    sg = StepGraphs(fn, "cuda")

    def step():
        loss, _ = sg(key, *inputs)
        return loss.item()  # waits for the replay

    wall_ms, busy_ms, kernels = profile_step(tag, f"{name} captured", step)
    replay_launches(tag, name, kernels, sg.graphs[key].launches)
    st = sg.stats()
    return wall_ms, busy_ms, st["capture_s"], st["pool_bytes"]


def replay_launches(tag, name, kernels, booked) -> None:
    """One replay's kernels on the device (a profile's device events)
    against the launches its graph books a replay (``booked``)."""
    seen = {k: n for k, n in device_launches((e.key, e.count) for e in kernels).items() if n}
    if seen != booked:
        raise AssertionError(f"{tag} {name}: a replay ran {seen} on the device, the graph "
                             f"books {booked}")
    print(f"{tag}   {name}: a replay ran {seen or 'none of the wrappers kernels'} on the "
          "device, as its graph books")


def train_profile(tc, resnet, policy_mod, pipeline, adam):
    """Where one dense and one sparse training step spend their time
    (:func:`profile_step`), eager and captured."""
    from repro_torch.launch import steps

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
        fn = steps.make_inplace_step(lambda p, pl, a, b: tc.loss_fn(RESNET, p, a, b, pl),
                                     params, opt, ocfg, lambda _, pol=pol: pol)
        cap = captured_profile("[train-profile]", name, fn, name, (x, y))
        out[name] = dict(wall_ms=wall_ms, busy_ms=busy_ms, captured_wall_ms=cap[0],
                         captured_busy_ms=cap[1], capture_s=cap[2], pool_bytes=cap[3])
    print(f"[train-profile] eager vs captured (host wall / device busy ms): {json.dumps(out)}",
          flush=True)
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
    meds["captured"] = captured_vs_eager(
        "[ddpm-train]", lambda a: td.fit(td.build_parser().parse_args(a)), argv, out)
    # the sampler: the same params and noise through the eager loop
    args = td.build_parser().parse_args(argv)
    eager, eager_s = td.sample_images(out["modes"]["ssprop"]["state"][0], args, capture=False)
    if not np.array_equal(eager, out["samples"]):
        raise AssertionError(f"[ddpm-train] captured samples != eager: max |d| "
                             f"{np.abs(eager - out['samples']).max():.3e}")
    meds["captured"]["eager_sample_s"] = eager_s
    print(f"[ddpm-train] sampling {DDPM_T} steps of 4 images: captured {out['sample_s']:.2f} s "
          f"(under the device tracing), "
          f"eager {eager_s:.2f} s, the samples bit for bit", flush=True)
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
    (:func:`profile_step`), eager and captured; then one denoising step of
    the sampler (4 images), eager and captured."""
    from repro_torch.launch import steps
    from repro_torch.launch.graphs import StepGraphs

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
        fn = steps.make_inplace_step(
            lambda p, pl, a, b, c: ddpm.loss_fn(p, sched, a, b, c, pl), params, opt, ocfg,
            lambda _, pol=pol: pol)
        cap = captured_profile("[ddpm-profile]", name, fn, name, (x0, t, noise))
        out[name] = dict(wall_ms=wall_ms, busy_ms=busy_ms, captured_wall_ms=cap[0],
                         captured_busy_ms=cap[1], capture_s=cap[2], pool_bytes=cap[3])
        del opt
    xs = torch.randn((4, *DDPM_IMAGE), device="cuda")
    zs = torch.randn_like(xs)
    ts = torch.tensor(500, device="cuda")
    for mode in ("eager", "captured"):
        sg = StepGraphs(lambda _, x, tt, z: ddpm.denoise_step(params, sched, x, tt, z), "cuda",
                        capture=mode == "captured")

        def denoise():
            with torch.no_grad():
                return sg(None, xs, ts, zs).sum().item()

        wall_ms, busy_ms, kernels = profile_step("[ddpm-profile]", f"sampler step {mode}",
                                                 denoise)
        if sg.captured:
            replay_launches("[ddpm-profile]", "sampler step", kernels, sg.graphs[None].launches)
        out[f"sampler_{mode}"] = dict(wall_ms=wall_ms, busy_ms=busy_ms)
    print(f"[ddpm-profile] eager vs captured (host wall / device busy ms): {json.dumps(out)}",
          flush=True)
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
    TF32 off, so the routes differ in summation order only. Returns the
    worst relative L2s, and the config, params, batch and site names for
    :func:`tp_lm_route_check`."""
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
    return worst, (cfg, params, batch, site_of)


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
    (:func:`profile_step`), and which ``matmul`` variant ran. Returns the
    profile, and the full-depth params, Adam state and batch for
    :func:`tp_lm_phase`."""
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
    return out, [params, opt, batch]


# ----------------------------------------------------------------------
# TP-local selection on qwen2.5-3b: the dryrun's two TP policies
# ----------------------------------------------------------------------

TP_SHARDS = 16  # the production mesh's model axis (launch/mesh.py)
TP_DEPTH = 3  # [tp-lm]'s timed steps: 36 layers cut to 3, room for the mesh phases
TP_STEPS = 4  # timed steps a policy, after a warm-up
COMPRESS_RATIO = 0.01


def tp_policies(policy_mod) -> dict:
    """The JAX dryrun's ``ssprop_tp`` (``tpu_default(0.8)`` with the model
    axis as ``tp_shards``) and ``opt`` (plus a bf16 backward)."""
    tp = dataclasses.replace(policy_mod.tpu_default(LM_RATE), tp_shards=TP_SHARDS)
    return {"ssprop_tp": tp, "opt": dataclasses.replace(tp, bwd_dtype="bfloat16")}


def tp_lm_route_check(lm, steps, backward, policy_mod, gm, cfg, params, batch, site_of):
    """``[tp-lm]`` route check: one sparse step of qwen2.5-3b at full width
    and depth ``LM_ROUTE_DEPTH``, fp32 (the LM route check's params and batch), under
    ``ssprop_tp`` through the TP fast path and the mask oracle: the same
    kept channels at every site, ``k_loc`` of them in each of the 16
    shards, every leaf within TRAIN_ROUTE_TOL, and no kernel launched
    (the fast path is plain ``einsum``, before any kernel)."""
    t0 = time.perf_counter()
    tp = tp_policies(policy_mod)["ssprop_tp"]
    res = {}
    for name, pol in (("tp", tp), ("mask", dataclasses.replace(tp, mask_mode=True))):
        before = dict(gm.launches)
        with backward.record_selections() as log:
            (loss, _), grads = steps.value_and_grad(
                lambda p, pol=pol: lm.loss_fn(cfg, p, batch, pol), params)
        torch.cuda.synchronize()
        if gm.launches != before:
            raise AssertionError(f"[tp-lm] the {name} route launched a kernel")
        res[name] = (loss.item(), _named_leaves(grads), {site_of[p]: s for p, s in log})
        del grads
    for site, sel in res["tp"][2].items():
        if sel.n_shards != TP_SHARDS:
            raise AssertionError(f"[tp-lm] {site}: {sel.n_shards} shards")
        _balanced(sel, lm.site_out_dim(cfg, site), TP_SHARDS, f"[tp-lm] {site}")
    worst = _compare_routes(res, "[tp-lm]")
    print(f"[tp-lm] {LM_ARCH} full width, depth {cfg.n_layers}, B={LM_BATCH} S={LM_SEQ}, fp32, "
          f"ssprop_tp (tp_shards={TP_SHARDS}): the TP fast path and the mask oracle keep the "
          f"same channels at all {len(res['tp'][2])} sites, k_loc a shard; loss "
          f"{res['tp'][0]:.6f}; worst relative L2 "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f" (limit {TRAIN_ROUTE_TOL}); 0 kernel launches; {time.perf_counter() - t0:.1f} s")
    return worst


def tp_lm_phase(lm, steps, adam, compression, flops, sparsity, policy_mod, gm, cfg, state,
                lm_ms):
    """``[tp-lm]``: each projection's kept channels under 16 shards against
    global selection, with the contraction FLOPs of each route; then
    ``TP_STEPS`` timed ``make_train_step`` steps of each TP policy (bf16,
    B=8, S=128, the profile's params and Adam state cut to ``TP_DEPTH``
    layers) beside ``[lm-train]``'s full-depth dense and sparse medians,
    and a profile of each
    (:func:`profile_step`); then ``compress_tree`` at
    1 % over one ``ssprop_tp`` step's gradients: its time, the bytes
    against the full gradients', and grad == kept + residual exactly.
    ``state`` is the list ``[params, Adam state, batch]``; it is emptied,
    so that the Adam state is freed before the compression."""
    t0 = time.perf_counter()
    params, opt, batch = state
    state.clear()
    cfg = dataclasses.replace(cfg, n_layers=TP_DEPTH)
    for tree in (params, opt.m, opt.v):
        del tree["stack"]["layers"][TP_DEPTH:]
    gc.collect()
    torch.cuda.empty_cache()
    pols = tp_policies(policy_mod)
    glob = dataclasses.replace(pols["ssprop_tp"], tp_shards=0)
    m = LM_BATCH * LM_SEQ
    d, hd = cfg.d_model, cfg.head_dim
    dims = {"q": (d, cfg.n_heads * hd), "k": (d, cfg.n_kv_heads * hd),
            "v": (d, cfg.n_kv_heads * hd), "o": (cfg.n_heads * hd, d),
            "gate": (d, cfg.d_ff), "up": (d, cfg.d_ff), "down": (cfg.d_ff, d)}
    for proj, (d_in, d_out) in dims.items():
        tp = pols["ssprop_tp"]
        print(f"[tp-lm] {proj:4s} D_in={d_in} D_out={d_out}: kept "
              f"{flops.gather_width(d_out, tp, TP_SHARDS)} under {TP_SHARDS} shards "
              f"(shard block {sparsity.shard_select_width(d_out, tp, TP_SHARDS)[1]}) against "
              f"{flops.kept_channels(d_out, glob)} global; contraction FLOPs: TP fast path "
              f"{flops.dense_backward_contraction_bounds(m, d_in, d_out, tp)[0]}, global "
              f"{flops.dense_backward_contraction_bounds(m, d_in, d_out, glob)[0]}, dense "
              f"{flops.dense_backward_contraction_bounds(m, d_in, d_out, policy_mod.DENSE)[0]}")
    ocfg = adam.AdamConfig(lr=2e-4, clip_norm=1.0)
    tokens = m
    out = {}
    for name, pol in pols.items():
        fn = steps.make_train_step(cfg, pol, ocfg)
        before = dict(gm.launches)
        times, losses = [], []
        for i in range(1 + TP_STEPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _, _, met = fn(params, opt, batch)  # in place
            losses.append(met["loss"].item())  # waits for the step
            if i:
                times.append((time.perf_counter() - t1) * 1e3)
        if gm.launches != before or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"[tp-lm] {name}: launches {gm.launches} (before {before}), "
                                 f"losses {losses}")
        print(f"[tp-lm] {name}: {TP_STEPS} steps at full width, depth {cfg.n_layers}, bf16, "
              f"B={LM_BATCH} S={LM_SEQ}: median {_median(times):.2f} ms ({tokens / _median(times) * 1e3:.0f} "
              f"tokens/s) against [lm-train]'s full-depth dense {lm_ms['dense_ms']:.2f} and sparse "
              f"{lm_ms['sparse_ms']:.2f} ms; step ms {[round(v, 2) for v in times]}; losses "
              f"{[round(v, 4) for v in losses]}; 0 kernel launches")
        _, busy_ms, _ = profile_step("[tp-lm-profile]", name,
                                     lambda fn=fn: fn(params, opt, batch)[2]["loss"].item())
        out[name] = dict(median_ms=_median(times), ms=times, tokens_per_s=tokens /
                         _median(times) * 1e3, busy_ms=busy_ms, losses=losses)
    del opt
    gc.collect()
    torch.cuda.empty_cache()
    (_, _), grads = steps.value_and_grad(
        lambda p: lm.loss_fn(cfg, p, batch, pols["ssprop_tp"]), params)
    residual = compression.init_residual(grads)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    kept, residual = compression.compress_tree(grads, residual, ratio=COMPRESS_RATIO)
    torch.cuda.synchronize()
    c_ms = (time.perf_counter() - t1) * 1e3
    leaves = list(zip(adam.tree_leaves(grads), adam.tree_leaves(kept),
                      adam.tree_leaves(residual), strict=True))
    bad = [i for i, (g, c, r) in enumerate(leaves)
           if not torch.equal(c.float() + r.float(), g.float())]
    if bad:
        raise AssertionError(f"[tp-lm] grad != kept + residual at leaves {bad[:5]}")
    full = sum(g.numel() * g.element_size() for g, _, _ in leaves)
    wire = compression.compressed_bytes(grads, COMPRESS_RATIO)
    out["compress"] = dict(ms=c_ms, full_bytes=full, compressed_bytes=wire, leaves=len(leaves))
    print(f"[tp-lm] compress_tree(ratio={COMPRESS_RATIO}) over one ssprop_tp step's "
          f"{len(leaves)} gradient leaves: {c_ms:.2f} ms; {full} bytes -> {wire} on the wire "
          f"({wire / full:.4f}); grad == kept + residual exactly at every leaf; phase "
          f"{time.perf_counter() - t0:.1f} s")
    del grads, kept, residual, leaves
    return out


# ----------------------------------------------------------------------
# fault-tolerant LM training: checkpoint, crash and resume; the fleet
# ----------------------------------------------------------------------

CKPT_DEPTH = 2  # qwen2.5-3b at full width, 36 layers cut to 2: a save holds ~4.7 GB
CKPT_DIR = ROOT / "build" / "ckpt_smoke"  # git-ignored, inside the checkout; removed after
FLEET_TIMEOUT_S = 300  # one rank process, start to exit
FLEET_SEQ = 64  # the fleet's reduced runs: B=LM_BATCH, S=64


def _same_files(a: Path, b: Path) -> bool:
    """Whether two step directories hold the same files, byte for byte."""
    names = sorted(f.name for f in a.iterdir())
    if names != sorted(f.name for f in b.iterdir()):
        return False
    for name in names:
        with open(a / name, "rb") as fa, open(b / name, "rb") as fb:
            while True:
                x, y = fa.read(1 << 26), fb.read(1 << 26)
                if x != y:
                    return False
                if not x:
                    break
    return True


def _save_line(sv) -> str:
    gb = sv["bytes"] / 1e9
    return (f"step {sv['step']}: blocking snapshot {sv['snapshot_s']:.3f} s ({gb / sv['snapshot_s']:.2f} "
            f"GB/s): pinned allocation {sv['alloc_s']:.3f} s, device-to-host copies "
            f"{sv['copy_s']:.3f} s ({gb / sv['copy_s']:.2f} GB/s); background write into the "
            f"page cache (no fsync) {sv['write_s']:.3f} s ({gb / sv['write_s']:.2f} GB/s)")


def ckpt_phase(train, lm, gm, adam, policy_mod, ckpt_lib):
    """The port's fault-tolerant LM path on the card: ``train.run`` on
    qwen2.5-3b at full width, depth ``CKPT_DEPTH`` (the CLI's
    ``get_config`` cut for the phase: the JAX CLI has no depth flag),
    bf16, B=8 S=128, ``paper_default(0.8)`` with ``--use-pallas``, 6 steps
    of 2-step epochs (2, 3 sparse), a checkpoint every 3, a crash
    injected at step 4: it saves step 3, restarts, resumes from 3, replays
    step 3 (sparse, through ``matmul``) and saves step 6. Beside it, the
    same run uninterrupted, once without checkpoints and once with them.
    The two must agree bit for bit (the step is deterministic on the
    card: the embedding's accumulating backward and the compact-dW
    ``index_add_`` included), and so must the resumed run's losses, the
    last occurrence of each step. The crashed run's checkpoints equal the
    uninterrupted run's byte for byte: at step 3 the state it saved, at
    step 6 the params, m and v it reached from the restored state.
    Returns (matmul launches of the crashed run, a summary)."""
    get_config = train.get_config
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=CKPT_DEPTH)
    argv = ["--arch", LM_ARCH, "--steps", "6", "--steps-per-epoch", "2", "--global-batch",
            str(LM_BATCH), "--seq-len", str(LM_SEQ), "--drop-rate", str(LM_RATE),
            "--granularity", "channel", "--use-pallas", "--log-every", "1", "--device", "cuda"]
    per_step = lm.kernel_launches_per_step(cfg, lm_policy(policy_mod))["matmul"]
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    crash_dir, whole_dir = CKPT_DIR / "crash", CKPT_DIR / "whole"
    crash_dir.mkdir(parents=True)
    free = shutil.disk_usage(CKPT_DIR).free
    print(f"[ckpt] {LM_ARCH} full width, depth {CKPT_DEPTH}: checkpoint dir {CKPT_DIR}, "
          f"{free / 1e9:.1f} GB free")

    def run(*extra):
        return train.run(train.build_parser().parse_args(argv + list(extra)))

    train.get_config = lambda arch: dataclasses.replace(get_config(arch), n_layers=CKPT_DEPTH)
    try:
        plain = run()
        whole = run("--ckpt-dir", str(whole_dir), "--ckpt-every", "3")
        for k in gm.launches:
            gm.launches[k] = 0
        t0 = time.perf_counter()
        out = run("--ckpt-dir", str(crash_dir), "--ckpt-every", "3", "--fail-at-step", "4")
        wall = time.perf_counter() - t0
        launches = dict(gm.launches)
    finally:
        train.get_config = get_config
    if out["steps"] != [0, 1, 2, 3, 3, 4, 5]:
        raise AssertionError(f"[ckpt] steps run {out['steps']}: no restart, or no resume at 3")
    if [r["step"] for r in out["ckpt"]["restores"]] != [3]:
        raise AssertionError(f"[ckpt] restores {out['ckpt']['restores']}, expected one of step 3")
    for name, o, d in (("crashed", out, crash_dir), ("uninterrupted", whole, whole_dir)):
        if [sv["step"] for sv in o["ckpt"]["saves"]] != [3, 6] or ckpt_lib.list_steps(
                str(d)) != [3, 6]:
            raise AssertionError(f"[ckpt] the {name} run's saves {o['ckpt']['saves']}")
    n_sparse = sum(1 for r in out["rates"] if r > 0)
    expect = dict.fromkeys(gm.launches, 0)
    expect["matmul"] = per_step * n_sparse
    if n_sparse != 3 or launches != expect or out["launches"] != expect:
        raise AssertionError(f"[ckpt] launches {launches} != {per_step} x {n_sparse} sparse "
                             "steps run (2, 3 and the replayed 3)")
    a, b = plain["history"], whole["history"]
    last = dict(zip(out["steps"], out["history"], strict=True))
    resumed = [last[i] for i in range(6)]
    if a != b:
        raise AssertionError(f"[ckpt] two uninterrupted runs differ: {a} / {b}")
    if resumed != a:
        raise AssertionError(f"[ckpt] resumed losses {resumed} != uninterrupted {a}")
    for step in (3, 6):
        name = f"step_{step:08d}"
        if not _same_files(crash_dir / name, whole_dir / name):
            raise AssertionError(f"[ckpt] the crashed run's {name} differs from the "
                                 "uninterrupted run's")
    # the file read alone: step 3 to host tensors, timed
    params = lm.init_params(cfg, 0, device="cuda")
    opt = adam.init(params)
    like = ckpt_lib.like_of({k: lm.jax_layout(cfg, t, ckpt_lib.Stacked)
                             for k, t in (("params", params), ("m", opt.m), ("v", opt.v))})
    del params, opt
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    host = ckpt_lib._flatten(ckpt_lib.restore(str(crash_dir), 3, like))[0]
    rs = time.perf_counter() - t0
    n_tensors = len(host)
    del host
    step_dir = crash_dir / "step_00000003"
    nbytes = sum(f.stat().st_size for f in step_dir.iterdir())
    saves = out["ckpt"]["saves"]
    total_rs = out["ckpt"]["restores"][0]["s"]
    print(f"[ckpt] {smi()}: {wall:.1f} s for the crashed run; steps run {out['steps']}; "
          f"restart and 'resumed from step 3'; its step-3 and step-6 checkpoints ({n_tensors} "
          "tensors: params, m, v) equal the uninterrupted run's byte for byte")
    print(f"[ckpt] a save writes {nbytes / 1e9:.3f} GB ({saves[0]['bytes'] / 1e9:.3f} GB of "
          f"tensors); restore (file to host tensors) {rs:.3f} s ({nbytes / rs / 1e9:.2f} GB/s), "
          f"to the card in the run {total_rs:.3f} s ({nbytes / total_rs / 1e9:.2f} GB/s)")
    for name, o in (("crashed", out), ("uninterrupted", whole)):
        for sv in o["ckpt"]["saves"]:
            print(f"[ckpt] {name} run's save at {_save_line(sv)}")
    print(f"[ckpt] matmul launches {launches['matmul']} = {per_step} x {n_sparse} sparse steps "
          "run (2, 3, replayed 3)")
    print(f"[ckpt] determinism: two uninterrupted runs agree bit for bit, losses {a}; so do "
          "the resumed run's (the last occurrence of each step)")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return launches["matmul"], dict(
        losses=a, save_gb=nbytes / 1e9, restore_s=rs, restore_to_card_s=total_rs,
        saves=[{k: sv[k] for k in ("step", "snapshot_s", "alloc_s", "copy_s", "write_s")}
               for sv in saves + whole["ckpt"]["saves"]])


def _fleet_cmd(coord, ckpt_dir, rank, world):
    return [sys.executable, "-m", "repro_torch.launch.train", "--device", "cuda",
            "--arch", LM_ARCH, "--reduced", "--use-pallas", "--steps", "6",
            "--steps-per-epoch", "4", "--global-batch", str(LM_BATCH), "--seq-len", str(FLEET_SEQ),
            "--log-every", "1", "--ckpt-dir", str(ckpt_dir), "--ckpt-every", "4",
            "--coord-dir", str(coord), "--world-size", str(world), "--rank", str(rank),
            "--hb-interval", "0.5", "--hb-timeout", "60", "--commit-timeout", "120",
            "--rejoin-timeout", "120"]


def _fleet_run(cmds: dict[str, list[str]], where: Path) -> dict[str, str]:
    """Run the commands at once, each its own process with its log;
    every one must exit 0 within ``FLEET_TIMEOUT_S``. Returns the logs."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs, logs = {}, {}
    try:
        for name, cmd in cmds.items():
            with open(where / f"{name}.log", "w") as f:
                procs[name] = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=f,
                                               stderr=subprocess.STDOUT)
        deadline = time.monotonic() + FLEET_TIMEOUT_S
        for name, p in procs.items():
            rc = p.wait(timeout=max(deadline - time.monotonic(), 1))
            logs[name] = (where / f"{name}.log").read_text()
            if rc != 0:
                raise AssertionError(f"[fleet] {name} exited {rc}: {logs[name][-3000:]}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return logs


def _loss_log(coord: Path, rank: int) -> dict[int, float]:
    out = {}
    for line in (coord / "loss" / f"rank_{rank:05d}.jsonl").read_text().splitlines():
        rec = json.loads(line)
        out[rec["step"]] = rec["loss"]  # a replayed step: the last occurrence
    return out


def _launches(log: str) -> dict:
    line = next(ln for ln in log.splitlines() if ln.startswith("[train] kernel launches:"))
    return ast.literal_eval(line.split(":", 1)[1].strip())


def fleet_phase(gm, lm, policy_mod, get_config):
    """Two ranks of ``python -m repro_torch.launch.train --reduced`` on the
    one card, as subprocesses, under ``--coord-dir`` and ``--world-size
    2`` with ``--ckpt-dir`` (compute replicated, as in the reference): 6
    steps of 4-step epochs (4, 5 sparse), a sharded checkpoint at step 4
    (a shard a rank, the manifest the leader committed). Then one process
    resumes from it (a reshaped fleet of 1) and runs steps 4-5; its
    losses must equal the fleet's there, and the two ranks' each other,
    bit for bit. Every process launched ``matmul`` the launch table's
    count for each sparse step it ran. First, ``matmul`` against its
    plain version at every product of the reduced config's sparse step
    (B=8, S=64: small shapes that no tile divides). Returns a summary,
    with those rows and their worst error."""
    cfg = get_config(LM_ARCH).reduced()
    k_rows, k_err = lm_kernel_phase(gm, lm, cfg, lm_policy(policy_mod), LM_BATCH, FLEET_SEQ,
                                    tag="[fleet-kernels]")
    root = CKPT_DIR / "fleet"
    shutil.rmtree(root, ignore_errors=True)
    coord, ckpt_dir, solo = root / "coord", root / "ckpt", root / "solo"
    for d in (coord, solo):
        d.mkdir(parents=True)
    per_step = lm.kernel_launches_per_step(cfg, lm_policy(policy_mod))["matmul"]
    t0 = time.perf_counter()
    logs = _fleet_run({f"rank{r}": _fleet_cmd(coord, ckpt_dir, r, 2) for r in (0, 1)}, root)
    t_fleet = time.perf_counter() - t0
    step_dir = ckpt_dir / "step_00000004"
    manifest = json.loads((step_dir / "manifest.json").read_text())
    shards = sorted(f.name for f in step_dir.iterdir() if f.name.startswith("shard_"))
    if not ((step_dir / "COMMITTED").exists() and manifest["format"] == "sharded"
            and manifest["ranks"] == [0, 1] and shards == ["shard_0.msgpack", "shard_1.msgpack"]):
        raise AssertionError(f"[fleet] step 4 is not a committed 2-rank sharded checkpoint: "
                             f"{manifest.get('format')} {manifest.get('ranks')} {shards}")
    t0 = time.perf_counter()
    logs.update(_fleet_run({"solo": _fleet_cmd(solo, ckpt_dir, 0, 1)}, root))
    t_solo = time.perf_counter() - t0
    if "resumed from step 4" not in logs["solo"]:
        raise AssertionError("[fleet] the single process did not resume from step 4")
    fleet = [_loss_log(coord, r) for r in (0, 1)]
    resumed = _loss_log(solo, 0)
    if sorted(resumed) != [4, 5] or any(sorted(f) != list(range(6)) for f in fleet):
        raise AssertionError(f"[fleet] steps logged {[sorted(f) for f in fleet]} / {sorted(resumed)}")
    pairs = [([fleet[1][s] for s in range(6)], [fleet[0][s] for s in range(6)]),
             ([resumed[s] for s in (4, 5)], [fleet[0][s] for s in (4, 5)])]
    for got, want in pairs:
        if got != want:
            raise AssertionError(f"[fleet] losses {got} != {want}")
    counts = {name: _launches(log)["matmul"] for name, log in logs.items()}
    want = {"rank0": 2 * per_step, "rank1": 2 * per_step, "solo": 2 * per_step}
    if counts != want:
        raise AssertionError(f"[fleet] matmul launches {counts} != {want}")
    print(f"[fleet] 2 ranks of the reduced {LM_ARCH} on one card: 6 steps in {t_fleet:.1f} s "
          f"(processes included), a committed sharded checkpoint at step 4 ({shards}, "
          f"{len(manifest['keys'])} tensors); one process resumed from it in {t_solo:.1f} s; "
          f"losses {[round(fleet[0][s], 6) for s in range(6)]} on both ranks, the resumed "
          f"run's at 4-5 equal bit for bit; matmul launches {counts} = {per_step} x 2 sparse steps each")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return dict(fleet_s=t_fleet, solo_s=t_solo, launches=counts, kernel_rows=k_rows,
                kernel_err=k_err)


# [fleet-mesh]: a fleet whose ranks each train on a 1x2 mesh, qwen2.5-3b at
# full width, 36 layers cut to 2 (as [ckpt]), fp32, B=2 S=128; 6 steps of
# 2-step epochs (2, 3 sparse), a save every 3
FLEET_MESH_DEPTH = 2
FLEET_MESH_LM = (2, 128)
FLEET_MESH_HB_S = 2.5  # --hb-timeout: a killed launcher is evicted within this
# both fleet ranks' checks hold at this step's start (once) until the fleet
# changes: rank 1's launcher is killed there, so the eviction comes at a step
# start after step 3's commit and before step 6's save, whatever the host's pace
FLEET_MESH_HOLD_STEP = 4
FLEET_MESH_GONE_S = 10.0  # the killed launcher's mesh ranks must be gone within
FLEET_MESH_TIMEOUT_S = 420  # one launcher, start to exit
# a launcher: the training CLI with the phase's depth and dtype (the CLI
# has no flag for either) and this script's rank body around the CLI's
_FLEET_MESH_LAUNCHER = """
import dataclasses
import chip_smoke
from repro_torch.launch import train
get_config = train.get_config
train.get_config = lambda arch: dataclasses.replace(get_config(arch), n_layers={depth},
                                                    dtype="float32")
train.run_rank = chip_smoke.fleet_mesh_rank
train.main()
"""


def _hold_fleet_check(args) -> None:
    """Make this process's fleet check (``FleetSupervisor.check_epoch``,
    which only mesh rank 0 runs) hold at step ``FLEET_MESH_HOLD_STEP``'s
    start, once: it marks ``<coord>/held/rank_<fleet>`` and polls the fleet
    until its epoch moves, then checks as always (and so raises
    ``MembershipChanged`` there)."""
    from repro_torch.dist import fault

    check_epoch, calls = fault.FleetSupervisor.check_epoch, [0]
    held = Path(args.coord_dir) / "held"

    def hold_then_check(sup, epoch):
        calls[0] += 1  # a check a step; the first attempt starts at step 0
        if calls[0] == FLEET_MESH_HOLD_STEP + 1:
            held.mkdir(exist_ok=True)
            (held / f"rank_{args.rank}").touch()
            deadline = time.monotonic() + FLEET_MESH_TIMEOUT_S
            while sup.view.read().epoch == epoch and time.monotonic() < deadline:
                if sup.should_poll(args.rank):
                    sup.poll()
                time.sleep(0.05)
        return check_epoch(sup, epoch)

    fault.FleetSupervisor.check_epoch = hold_then_check


def fleet_mesh_rank(mesh, args, cfg=None, collect=()):
    """A ``[fleet-mesh]`` mesh rank: the training CLI's rank body
    (``train.run_rank``) with every ``matmul`` product held to the plain
    version on its own operands (the checks go to
    ``<coord>/checks/rank_<fleet>_mesh_<m>.json``) and, in a fleet, the
    fleet check's hold (:func:`_hold_fleet_check`)."""
    from repro_torch.kernels import gathered_matmul as gm
    from repro_torch.launch import train

    if args.world_size > 1:
        _hold_fleet_check(args)
    checks = {}
    with gm.observe_matmul(matmul_checker(checks, gm)("fleet-mesh")):
        out = train.run_rank(mesh, args, cfg, collect)
    path = Path(args.coord_dir) / "checks" / f"rank_{args.rank:05d}_mesh_{mesh.rank}.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(checks.get("fleet-mesh", [0, 0.0, 0.0, None])))
    return out


def _fleet_mesh_argv(coord, ckpt_dir, rank, world):
    b, seq = FLEET_MESH_LM
    argv = ["--arch", LM_ARCH, "--steps", "6", "--steps-per-epoch", "2", "--global-batch",
            str(b), "--seq-len", str(seq), "--drop-rate", str(LM_RATE), "--granularity",
            "channel", "--use-pallas", "--log-every", "1", "--device", "cuda"]
    if coord is None:  # the 1x1 run in this process
        return argv
    return argv + ["--ckpt-dir", str(ckpt_dir), "--ckpt-every", "3", "--coord-dir", str(coord),
                   "--world-size", str(world), "--rank", str(rank), "--data-mesh", "1",
                   "--model-mesh", "2", "--hb-interval", "0.25", "--hb-timeout",
                   str(FLEET_MESH_HB_S), "--commit-timeout", "20", "--rejoin-timeout", "120"]


def _pid_alive(pid: int) -> bool:
    """Whether ``pid`` runs (by ``/proc``; a zombie, dead but not reaped, does not)."""
    try:
        state = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0]
    except (OSError, IndexError):
        return False
    return state not in ("Z", "X")


def _card_pids() -> set[int]:
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return {int(x) for x in out.split() if x.strip().isdigit()}


def _train_json(log: str, prefix: str):
    line = next(ln for ln in reversed(log.splitlines()) if ln.startswith(prefix))
    return json.loads(line[len(prefix):])


def fleet_mesh_phase(train, lm, gm, policy_mod, get_config, card):
    """``[fleet-mesh]``: a fleet whose ranks each train on a 1x2 mesh (see
    the module docstring). Runs the 1x1 run, then starts the launchers
    and a thread that drives them, and returns ``finish()``: the caller
    runs other phases meanwhile (the launchers are processes of their
    own), then ``finish()`` waits for the thread, checks what the
    launchers wrote and returns a summary with the ``matmul`` launches
    of every mesh rank that ran to its end."""
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=FLEET_MESH_DEPTH, dtype="float32")
    root = CKPT_DIR / "fleet_mesh"
    shutil.rmtree(root, ignore_errors=True)
    coord, ckpt_dir, solo, solo_ckpt = (root / "coord", root / "ckpt", root / "solo",
                                        root / "solo_ckpt")
    for d in (coord, solo, solo_ckpt):
        d.mkdir(parents=True)
    t_phase = time.perf_counter()
    one = train.run(train.build_parser().parse_args(_fleet_mesh_argv(None, None, 0, 1)),
                    cfg=cfg)["history"]
    gc.collect()
    torch.cuda.empty_cache()
    t_one = time.perf_counter() - t_phase
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    code = _FLEET_MESH_LAUNCHER.format(depth=FLEET_MESH_DEPTH)

    def launch(name, argv):
        with open(root / f"{name}.log", "w") as f:
            return subprocess.Popen([sys.executable, "-c", code, *argv], cwd=ROOT, env=env,
                                    stdout=f, stderr=subprocess.STDOUT)

    def wait_for(cond, what, procs, timeout_s):
        deadline = time.monotonic() + timeout_s
        while not cond():
            for name, p in procs.items():
                if p.poll() not in (None, 0):
                    raise AssertionError(f"[fleet-mesh] {name} exited {p.returncode} waiting "
                                         f"for {what}: {(root / f'{name}.log').read_text()[-3000:]}")
            if time.monotonic() > deadline:
                raise AssertionError(f"[fleet-mesh] no {what} within {timeout_s} s")
            time.sleep(0.1)

    step3, step6 = ckpt_dir / "step_00000003", ckpt_dir / "step_00000006"
    held = [coord / "held" / f"rank_{r}" for r in (0, 1)]
    procs, got = {}, {}

    def stop():
        for p in list(procs.values()):
            if p.poll() is None:
                p.kill()
                p.wait()

    atexit.register(stop)  # no launcher outlives the script, whatever fails

    def drive():
        try:
            t0 = time.perf_counter()
            procs.update({f"rank{r}": launch(f"rank{r}", _fleet_mesh_argv(coord, ckpt_dir, r, 2))
                          for r in (0, 1)})
            wait_for(lambda: (step3 / "COMMITTED").exists() and all(h.exists() for h in held),
                     f"committed step 3 with both fleet ranks held at step {FLEET_MESH_HOLD_STEP}",
                     procs, FLEET_MESH_TIMEOUT_S)
            t_commit = time.perf_counter() - t0
            manifest = json.loads((step3 / "manifest.json").read_text())
            shards = sorted(f.name for f in step3.iterdir() if f.name.startswith("shard_"))
            if manifest["ranks"] != [0, 1] or shards != ["shard_0.msgpack", "shard_1.msgpack"]:
                raise AssertionError(f"[fleet-mesh] step 3: ranks {manifest['ranks']}, {shards}")
            shard_bytes = {f.name: f.stat().st_size for f in step3.iterdir()
                           if f.name.startswith("shard_")}
            pids = [int((coord / "pids" / f"rank_00001_mesh_{m}").read_text()) for m in (0, 1)]
            if not all(_pid_alive(p) for p in pids):
                raise AssertionError(f"[fleet-mesh] fleet rank 1's mesh ranks {pids} not running")
            on_card = _card_pids()
            t_kill = time.perf_counter()
            procs["rank1"].kill()
            procs["rank1"].wait(30)
            while any(_pid_alive(p) for p in pids):
                if time.perf_counter() - t_kill > FLEET_MESH_GONE_S:
                    raise AssertionError(f"[fleet-mesh] fleet rank 1's mesh ranks {pids} alive "
                                         f"{FLEET_MESH_GONE_S} s after its launcher's SIGKILL")
                time.sleep(0.05)
            t_gone = time.perf_counter() - t_kill
            # nvidia-smi lists a process only where it shares the tool's pid
            # namespace; where it listed the mesh ranks, it must list them no more
            if on_card & set(pids):
                still = _card_pids() & set(pids)
                if still:
                    raise AssertionError(f"[fleet-mesh] nvidia-smi lists the killed mesh ranks {still}")
                smi = f"nvidia-smi listed {sorted(on_card & set(pids))} before and none after"
            else:
                smi = (f"nvidia-smi lists {sorted(on_card)}, none of the mesh ranks (another pid "
                       f"namespace): /proc alone shows them gone")
            # a world-1 launcher resumes from step 3 (its own directory: the
            # step's files linked), beside fleet rank 0's restart; no save of
            # its own: --ckpt-every past the end
            shutil.copytree(step3, solo_ckpt / step3.name, copy_function=os.link)
            t_solo0 = time.perf_counter()
            procs["solo"] = launch("solo", _fleet_mesh_argv(solo, solo_ckpt, 0, 1)
                                   + ["--ckpt-every", "100"])
            live, ends = {n: procs[n] for n in ("rank0", "solo")}, {}

            def both_exited():
                for n, p in live.items():
                    if n not in ends and p.poll() == 0:
                        ends[n] = time.perf_counter()
                return len(ends) == len(live)

            wait_for(both_exited, "exit of fleet rank 0 and the world-1 launcher", live,
                     FLEET_MESH_TIMEOUT_S)
            t_fleet, t_solo = ends["rank0"] - t0, ends["solo"] - t_solo0
            membership = json.loads((coord / "membership.json").read_text())
            m6 = json.loads((step6 / "manifest.json").read_text())
            if membership["evicted"] != [1] or m6["ranks"] != [0] or not (
                    step6 / "COMMITTED").exists():
                raise AssertionError(f"[fleet-mesh] membership {membership}, step 6 ranks "
                                     f"{m6['ranks']}")
            got.update(t_commit=t_commit, shard_bytes=shard_bytes, pids=pids, on_card=on_card,
                       t_gone=t_gone, smi=smi, t_fleet=t_fleet, t_solo=t_solo)
        except BaseException as e:
            got["error"] = e
        finally:
            stop()

    worker = threading.Thread(target=drive, name="fleet-mesh", daemon=True)
    worker.start()
    return lambda: _fleet_mesh_finish(worker, got, root, coord, solo, one, t_one, t_phase, card)


def _fleet_mesh_finish(worker, got, root, coord, solo, one, t_one, t_phase, card):
    """``[fleet-mesh]``'s checks once its launchers have run (see
    :func:`fleet_mesh_phase`)."""
    worker.join()
    if "error" in got:
        raise got["error"]
    t_commit, shard_bytes, pids, on_card, t_gone, smi, t_fleet, t_solo = (got[k] for k in (
        "t_commit", "shard_bytes", "pids", "on_card", "t_gone", "smi", "t_fleet", "t_solo"))
    logs = {name: (root / f"{name}.log").read_text() for name in ("rank0", "rank1", "solo")}
    for name in ("rank0", "solo"):
        if "resumed from step 3" not in logs[name]:
            raise AssertionError(f"[fleet-mesh] {name} did not resume from step 3")
    lines = [ln for ln in logs["rank0"].splitlines() if "resharding to epoch" in ln]
    if len(lines) != 1:
        raise AssertionError(f"[fleet-mesh] fleet rank 0 resharded {len(lines)} times: {lines}")
    fleet0 = _loss_log(coord, 0)
    resumed = _loss_log(solo, 0)
    if sorted(fleet0) != list(range(6)) or sorted(resumed) != [3, 4, 5]:
        raise AssertionError(f"[fleet-mesh] steps {sorted(fleet0)} / {sorted(resumed)}")
    if [resumed[s] for s in (3, 4, 5)] != [fleet0[s] for s in (3, 4, 5)]:
        raise AssertionError(f"[fleet-mesh] the world-1 launcher's losses {resumed} != fleet "
                             f"rank 0's {fleet0}")
    rel = max(abs(fleet0[s] - one[s]) / abs(one[s]) for s in range(3))
    if rel > MESH_LOSS_TOL:
        raise AssertionError(f"[fleet-mesh] steps 0-2 {[fleet0[s] for s in range(3)]} vs 1x1 "
                             f"{one[:3]}: rel {rel}")
    launches, checks = {}, {}
    for name in ("rank0", "solo"):
        by_rank = _train_json(logs[name], "[train] kernel launches by mesh rank: ")
        if by_rank["launches"] != by_rank["table"] or any(
                r["matmul"] == 0 for r in by_rank["launches"]):
            raise AssertionError(f"[fleet-mesh] {name} launches {by_rank}")
        launches[name] = [r["matmul"] for r in by_rank["launches"]]
        for m in (0, 1):
            n, err, limit, miss = json.loads(
                ((coord if name == "rank0" else solo) / "checks" / f"rank_00000_mesh_{m}.json")
                .read_text())
            if miss is not None or n != launches[name][m]:
                raise AssertionError(f"[fleet-mesh] {name} mesh rank {m}: {n} products "
                                     f"checked of {launches[name][m]}; {miss}")
            checks[f"{name} mesh {m}"] = err
    ck0 = _train_json(logs["rank0"], "[train] checkpoint: ")
    ck_solo = _train_json(logs["solo"], "[train] checkpoint: ")
    if [s["step"] for s in ck0["saves"]] != [3, 6] or [
            r["step"] for r in ck0["restores"]] != [3]:
        raise AssertionError(f"[fleet-mesh] fleet rank 0 saved {ck0['saves']}, restored "
                             f"{ck0['restores']}: not one save each of steps 3 and 6 and one "
                             f"restore of step 3")
    saves = {"rank0": ck0["saves"], "rank1": [
        _train_json(logs["rank1"], "[train] saved step 3: ")]}
    restores = {"rank0": ck0["restores"], "solo": ck_solo["restores"]}
    summary = dict(
        one_s=t_one, commit_s=t_commit, fleet_s=t_fleet, solo_s=t_solo, gone_s=t_gone,
        losses={s: fleet0[s] for s in range(6)}, rel_vs_1x1=rel, shard_bytes=shard_bytes,
        saves=saves, restores=restores, launches=launches, matmul_err=checks,
        card_pids_before_kill=sorted(on_card), killed=pids, phase_s=time.perf_counter() - t_phase)
    print(f"[fleet-mesh] {LM_ARCH} full width, depth {FLEET_MESH_DEPTH}, fp32, B="
          f"{FLEET_MESH_LM[0]} S={FLEET_MESH_LM[1]}, 2 launchers x 1x2 on one card ({card}): "
          f"step 3 committed and both held at step {FLEET_MESH_HOLD_STEP}'s start "
          f"{t_commit:.1f} s after launch ({shard_bytes}); fleet rank 1's launcher SIGKILLed, "
          f"its mesh ranks {pids} gone in {t_gone:.2f} s by /proc ({smi}); rank 0 evicted it "
          f"at step {FLEET_MESH_HOLD_STEP}, restarted once from step 3 at world 1 (step 6 "
          f"ranks [0]) and exited 0 {t_fleet:.1f} s after launch; a world-1 launcher on 1x2, "
          f"beside it, resumed from step 3 in {t_solo:.1f} s, losses 3-5 equal rank 0's bit "
          f"for bit; steps 0-2 within {rel:.2e} of the 1x1 run ({t_one:.1f} s)")
    print(f"[fleet-mesh] matmul launches by mesh rank {launches} = the launch table's, every "
          f"product within the gate (worst {max(checks.values()):.3g}); saves {json.dumps(saves)}; "
          f"restores {json.dumps(restores)}")
    print(f"[time] [fleet-mesh] phase {summary['phase_s']:.1f} s (the launchers beside [audit] "
          f"and [dryrun])", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return summary


# ----------------------------------------------------------------------
# device meshes: qwen2.5-3b trains on data x model and serves on model,
# a rank a process over gloo (the ranks share the one card)
# ----------------------------------------------------------------------

MESH_DEPTH = 2  # [mesh-train]: full width, 36 layers cut to 2 (PR 30; 4 before)
MESH_STEPS = 3  # a dense step, then two sparse ones (--scheduler bar)
MESH_SHAPES = ((1, 2), (2, 1))  # (data, model) beside 1x1
MESH_LOSS_TOL = 1e-4  # fp32, TF32 off: summation order only
MESH_TIMEOUT_S = 300  # one mesh run, spawn to exit
MESH_PROBE = "layer_0/attn/o"  # the row-parallel site whose dY must agree bit for bit
MESH_SERVE_MODEL = 2  # [mesh-serve]: 8 q heads on 1 KV head a rank
MESH_SERVE_DEPTH = 3  # [mesh-serve]: 36 layers cut to 3 (the script must end inside 1200 s)
MESH_DATA = 2  # [mesh-data-serve]: --data-mesh 2, the serve phase's 4 slots 2 a rank
# [mesh-data-serve]'s lock-step runs: name -> (data, model, decode_seq_shard)
MESH_LOCK = {"1x2": (1, 2, False), "2x1": (2, 1, False), "1x2 seq-model": (1, 2, True)}
MESH_LOCK_DEPTH = 1  # their depth (and the counted step's): 318 gloo-bound steps a run (PR 30; 2 before)
# [mesh-seq]: a global batch --data-mesh 2 does not divide, so data moves to
# the sequence dim as the reference's fit_spec places it; qwen2.5-3b at full
# width, B=3 S=128 (64 positions a rank), 36 layers cut to 2 (the script's
# last phase stays under ~800 s)
MESH_SEQ_LM = (3, 128)
MESH_SEQ_DEPTH = 2
MESH_SEQ_LOSS_TOL = 1e-5  # the seq-split runs' losses against 1x1's, relative


def _mesh_train_argv(data, model):
    return ["--arch", LM_ARCH, "--steps", str(MESH_STEPS), "--scheduler", "bar",
            "--global-batch", str(LM_BATCH), "--seq-len", str(LM_SEQ), "--drop-rate", str(LM_RATE),
            "--granularity", "channel", "--use-pallas", "--log-every", "1", "--device", "cuda",
            "--data-mesh", str(data), "--model-mesh", str(model)]


def mesh_seq_ranks(mesh21, cases, checker, free):
    """``[mesh-seq]`` in a rank of a two-rank spawn: the training CLI's rank
    body on the 2x1 mesh ``mesh21`` once a case of ``cases`` (``{name:
    (argv, cfg)}``, a global batch ``--data-mesh 2`` does not divide: each
    rank steps its block of the sequence, ``models/model.py::batch_layout``),
    the kept channels collected; the kernels' counts set to 0 just before
    each run and read just after it, every ``matmul`` launch held to its
    plain version on its own operands (``checker(f"seq {name}")``), and the
    collectives the run made (``dist/parallel.py::counters``, the sequence
    split's apart). Returns ``({name: the CLI's dict with "counted" and
    "collectives"}, {part: wall s})``."""
    from repro_torch.dist import parallel
    from repro_torch.kernels import gathered_matmul as gm
    from repro_torch.launch import train

    out, walls = {}, {}
    for name, (argv, cfg) in cases.items():
        t0 = time.perf_counter()
        for k in gm.launches:
            gm.launches[k] = 0
        parallel.counters.update(calls=0, bytes=0, s=0.0, seq_calls=0, seq_bytes=0,
                                 kv_sum_calls=0, kv_sum_bytes=0)
        with gm.observe_matmul(checker(f"seq {name}")):
            res = train.run_rank(mesh21, train.build_parser().parse_args(argv), cfg, ("kept",))
        out[name] = dict(res, counted=dict(gm.launches), collectives=dict(parallel.counters))
        free()
        walls[f"seq {name}"] = time.perf_counter() - t0
        if mesh21.rank == 0:
            print(f"[mesh-seq] rank 0: {name} 2x1 in {walls[f'seq {name}']:.1f} s", flush=True)
    return out, walls


def mesh_seq_report(one, got, every, one_launches, card):
    """Checks and prints ``[mesh-seq]``: each 2x1 run of ``got`` against its
    1x1 run in ``one`` (same batch, depth and seed): the losses within
    ``MESH_SEQ_LOSS_TOL``, the kept channels of every site at the first sparse
    step equal, each rank's ``matmul`` launches equal to the launch table's
    (rank 0's counted from 0 around the run too) and no other kernel, every
    one of them checked against the plain version within ``KERNEL_TOL``
    (``every``: each rank's ``checks``), and the sequence split's
    collectives a step. Returns (``matmul`` launches: the 1x1 runs'
    ``one_launches`` and every rank's; the worst product error; a
    summary)."""
    launches, worst, summary = one_launches, 0.0, {}
    for name, out in got.items():
        ref = one[name]
        rel = max(abs(a - b) / abs(b) for a, b in zip(out["history"], ref["history"], strict=True))
        first = min(st for st, v in ref["kept"].items() if v)  # the first sparse step
        sites = ref["kept"][first]
        differ = sorted(s for s, v in sites.items() if out["kept"][first].get(s) != v)
        differ += sorted(set(out["kept"][first]) - set(sites))
        by_rank = [r["matmul"] for r in out["launches_by_rank"]]
        table = [r["matmul"] for r in out["launch_table_by_rank"]]
        checked = []
        for r in every:
            mine = [c for k, c in r["checks"].items()
                    if k == f"seq {name}" or k.startswith(f"seq {name} ")]
            checked.append((sum(c[0] for c in mine), max((c[1] for c in mine), default=0.0),
                            next((c[3] for c in mine if c[3] is not None), None)))
        if not all(math.isfinite(v) for v in out["history"]) or rel > MESH_SEQ_LOSS_TOL:
            raise AssertionError(f"[mesh-seq] {name} losses {out['history']} vs 1x1 "
                                 f"{ref['history']}: rel {rel:.3g} > {MESH_SEQ_LOSS_TOL}")
        if differ:
            raise AssertionError(f"[mesh-seq] {name}: the first sparse step's kept sets differ "
                                 f"from 1x1's at {differ}")
        others = sum(v for r in out["launches_by_rank"] for k, v in r.items() if k != "matmul")
        if (by_rank != table or not all(by_rank) or others
                or out["counted"]["matmul"] != by_rank[0]):
            raise AssertionError(f"[mesh-seq] {name} launches {out['launches_by_rank']} (rank 0 "
                                 f"counted {out['counted']}) != the table's {table}")
        if [c[0] for c in checked] != by_rank or any(c[2] for c in checked):
            raise AssertionError(f"[mesh-seq] {name}: products checked {checked} of {by_rank}")
        worst = max([worst] + [c[1] for c in checked])
        launches += sum(by_rank)
        steps, coll = len(out["history"]), out["collectives"]
        row = dict(losses=out["history"], loss_rel=rel, first_sparse_step=first,
                   kept_sites=len(sites), matmul_by_rank=by_rank,
                   products_worst=max(c[1] for c in checked),
                   seq_calls_per_step=coll["seq_calls"] / steps,
                   seq_mb_per_step=coll["seq_bytes"] / steps / 1e6,
                   kv_sum_calls_per_step=coll["kv_sum_calls"] / steps,
                   kv_sum_mb_per_step=coll["kv_sum_bytes"] / steps / 1e6,
                   collective_calls_per_step=coll["calls"] / steps,
                   collective_mb_per_step=coll["bytes"] / steps / 1e6)
        summary[name] = row
        print(f"[mesh-seq] {name} 2x1 ({card}): losses {out['history']} (max rel {rel:.3g} of 1x1 "
              f"{ref['history']}); first sparse step {first}: kept sets equal to 1x1's at all "
              f"{len(sites)} sites; matmul launches by rank {by_rank} = the table's, every "
              f"product within {KERNEL_TOL} x max(1, max|plain|) of the plain version (worst "
              f"{row['products_worst']:.3g}); the sequence split's collectives a step "
              f"{row['seq_calls_per_step']:g} calls, {row['seq_mb_per_step']:.2f} MB (of them "
              f"the cross K/V gradient sums {row['kv_sum_calls_per_step']:g} calls, "
              f"{row['kv_sum_mb_per_step']:.2f} MB; all collectives "
              f"{row['collective_calls_per_step']:g} calls, "
              f"{row['collective_mb_per_step']:.2f} MB)", flush=True)
    return launches, worst, summary


def mesh_ranks(mesh, train_argvs, serve_argv, cfg, serve_cfgs, policy, steps, probe,
               base_serve_argv, lock_cfg, seq_cases):
    """Every mesh run of ``[mesh-train]``, ``[mesh-serve]`` and
    ``[mesh-data-serve]``, in one spawn of two ranks on the card: the
    training CLI's rank body (``train.run_rank``, fp32, the kept channels
    collected) on this 1x2 mesh and on a 2x1 mesh over the same ranks,
    then :func:`mesh_timed_steps` in bf16 at 1x2, then the serving CLI's
    rank body (``serve.serve_rank``) once a config of ``serve_cfgs``, then
    :func:`mesh_data_serve` (``base_serve_argv``, the fp32 config, the
    lock-step runs at ``lock_cfg``), then :func:`mesh_seq_ranks` of
    ``seq_cases`` on a 2x1 mesh. Every
    ``matmul`` launch of the fp32 runs and of the bf16 warm-up step is
    held against its plain version on the same operands
    (``gathered_matmul.observe_matmul``). Returns (the CLI's dict of each
    training layout, every rank's bf16 timings, each config's serving
    dict, every rank's product checks, the ranks' wall of each part, the
    data-mesh serving results, the ``[mesh-seq]`` runs)."""
    import torch.distributed as dist

    from repro_torch.kernels import gathered_matmul as gm
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import serve, train

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain products in full fp32
    checks = {}  # 'layout dtype' -> [products, worst error, largest limit, first miss]

    def checker(layout):
        def check(a, b, out):
            ref = gm.matmul_ref(a, b)
            err = (out - ref).abs().max().item()
            limit = KERNEL_TOL * max(1.0, ref.abs().max().item())
            c = checks.setdefault(f"{layout} {str(a.dtype).replace('torch.', '')}",
                                  [0, 0.0, 0.0, None])
            c[0] += 1
            c[1] = max(c[1], err)
            c[2] = max(c[2], limit)
            if err > limit and c[3] is None:
                c[3] = f"A{tuple(a.shape)} @ B{tuple(b.shape)}: {err} > {limit}"
        return check

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    walls, train_outs = {}, {}
    for layout, argv in train_argvs.items():
        t0 = time.perf_counter()
        m = mesh if layout == "1x2" else mesh_lib.make_host_mesh(2, 1, "cuda")
        with gm.observe_matmul(checker(layout)):
            train_outs[layout] = train.run_rank(m, train.build_parser().parse_args(argv), cfg,
                                                ("kept",))
        free()
        walls[layout] = time.perf_counter() - t0
    t0 = time.perf_counter()
    timed = mesh_timed_steps(mesh, dataclasses.replace(cfg, dtype="bfloat16"), policy, steps,
                             probe, checker("1x2"))
    free()
    walls["1x2 bf16"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    args = serve.build_parser().parse_args(serve_argv)
    served = []
    for c in serve_cfgs:
        served.append(serve.serve_rank(mesh, args, c))
        free()
    walls["serve"] = time.perf_counter() - t0
    data_served = mesh_data_serve(mesh, base_serve_argv, serve_cfgs[0], lock_cfg, walls, free)
    seq_outs, seq_walls = mesh_seq_ranks(mesh_lib.make_host_mesh(2, 1, "cuda"), seq_cases,
                                         checker, free)
    walls.update(seq_walls)
    every = [None] * mesh.world
    dist.all_gather_object(every, {"rank": mesh.rank, "checks": checks})
    return train_outs, timed, served, every, walls, data_served, seq_outs


def mesh_data_serve(mesh, argv, cfg, lock_cfg, walls, free):
    """``[mesh-data-serve]`` in a rank of the 1x2 spawn: the serving CLI's
    rank body with ``cfg`` (fp32) on a 2x1 mesh over the same ranks
    (``--data-mesh 2``, the paged engine), then with ``lock_cfg`` (fp32,
    ``MESH_LOCK_DEPTH`` layers) the lock-step engine on each ``MESH_LOCK``
    layout and one lock-step decode step (the CLI's slots and
    ``max_seq``, from position 0) at 1x2 and 2x1 with the collectives
    counted (``parallel.counters``). Returns rank 0's serving dicts and
    every rank's step counts; ``walls`` gains each part's seconds."""
    import torch.distributed as dist

    from repro_torch.dist import parallel
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import serve
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import model as lm

    data = mesh_lib.make_host_mesh(MESH_DATA, 1, mesh.device.type)
    t0 = time.perf_counter()
    args = serve.build_parser().parse_args(argv + ["--data-mesh", str(MESH_DATA)])
    out = {"data": serve.serve_rank(data, args, cfg)}
    free()
    walls["data serve"] = time.perf_counter() - t0
    lock_args = serve.build_parser().parse_args(argv + ["--engine", "lockstep"])
    for name, (d, _, seq) in MESH_LOCK.items():
        t0 = time.perf_counter()
        out[name] = serve.serve_rank(data if d > 1 else mesh, lock_args,
                                     dataclasses.replace(lock_cfg, decode_seq_shard=seq))
        free()
        walls[f"lockstep {name}"] = time.perf_counter() - t0
    b, max_seq = lock_args.batch, lock_args.prompt_len + lock_args.gen

    def nbytes(tree):
        from repro_torch.optim import adam

        return sum(t.numel() * t.element_size() for t in adam.tree_leaves(tree))

    steps = {}
    for name, m in (("1x2", mesh), ("2x1", data)):
        params = serve.rank_params(lock_cfg, 0, m.device, m)
        layout = lm.cache_layout(lock_cfg, m, b, max_seq)
        cache = lm.init_local_cache(lock_cfg, layout, m, max_seq=max_seq, device=m.device)
        rows = layout.slots[1] - layout.slots[0]
        state = {"tokens": torch.zeros((rows, 1), dtype=torch.int32, device=m.device),
                 "pos": 0, "cache": cache}
        step = steps_lib.make_serve_step(lock_cfg, mesh=m, layout=layout)
        parallel.counters.update(calls=0, bytes=0, s=0.0)
        with torch.no_grad():
            step(params, state)["tokens"].cpu()
        mine = dict(rank=m.rank, calls=parallel.counters["calls"], bytes=parallel.counters["bytes"],
                    param_bytes=nbytes(params), cache_bytes=nbytes(cache))
        every = [None] * m.world
        dist.all_gather_object(every, mine)
        steps[name] = every
        del params, cache, state
        free()
    out["step"] = {"batch": b, "max_seq": max_seq, "ranks": steps}
    return out


def mesh_timed_steps(mesh, cfg, policy, steps, probe, check):
    """One rank's timed steps: its shards of ``cfg``'s params (seed 0),
    ``make_train_step`` on the mesh, a warm-up step (its ``matmul``
    launches held to their plain version by ``check``, and ``probe``'s
    dY, a row-parallel site, recorded to compare the model ranks' bits),
    then ``steps`` steps timed (host wall, each ending in a device sync;
    the collectives' calls and bytes counted), one profiled (the rank's
    device busy time) and one with every collective timed
    (``parallel.timed_collectives``: the device synchronised around each,
    so its wall is the collective's own; gloo stages CUDA tensors through
    host memory). Returns every rank's numbers (rank 0 gathers them)."""
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import backward
    from repro_torch.data.pipeline import TokenPipeline, TokenPipelineConfig
    from repro_torch.dist import parallel
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels import gathered_matmul as gm
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import model as lm
    from repro_torch.optim import adam

    params = lm.init_params(cfg, 0, device=mesh.device)
    specs = lm.mesh_specs(cfg, params, mesh.shape)
    local = shd.shard_tree(params, specs, mesh)
    del params
    torch.cuda.empty_cache()
    sharded = shd.map_specs(lambda _, sp: shd.is_split(sp), local, specs)
    opt = adam.init(local)
    step = steps_lib.make_train_step(cfg, policy, adam.AdamConfig(lr=2e-4, clip_norm=1.0),
                                     mesh=mesh, sharded=sharded)
    pipe = TokenPipeline(TokenPipelineConfig(cfg.vocab, LM_SEQ, LM_BATCH, 0))
    rows = LM_BATCH // mesh.data
    r0 = mesh.data_rank * rows
    batches = [{k: torch.from_numpy(v[r0:r0 + rows]).cuda() for k, v in pipe.batch_at(i).items()}
               for i in range(steps)]

    def run(i):
        return step(local, opt, batches[i % steps])[2]["loss"].item()  # waits for the step

    with backward.record_cotangents([probe]) as dys, gm.observe_matmul(check):
        run(0)
    every = parallel.all_gather(dys[probe][None], mesh.model_group, mesh.model, dim=0)
    dy_spread = float((every - every[:1]).abs().max())
    wall = []
    parallel.counters.update(calls=0, bytes=0, s=0.0)
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(i)
        wall.append((time.perf_counter() - t0) * 1e3)
    calls, nbytes = parallel.counters["calls"] // steps, parallel.counters["bytes"] // steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(0)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    parallel.counters.update(calls=0, bytes=0, s=0.0)
    with parallel.timed_collectives():
        t0 = time.perf_counter()
        run(1)
        synced_ms = (time.perf_counter() - t0) * 1e3
    mine = dict(rank=mesh.rank, step_ms=wall, busy_ms=busy_ms, dy_spread=dy_spread,
                coll_ms=parallel.counters["s"] * 1e3, coll_calls=calls,
                coll_bytes=nbytes, synced_step_ms=synced_ms,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                param_bytes=sum(t.numel() * t.element_size() for t in adam.tree_leaves(local)),
                adam_bytes=sum(t.numel() * t.element_size()
                               for t in adam.tree_leaves([opt.m, opt.v, opt.step])))
    out = [None] * mesh.world
    dist.all_gather_object(out, mine)
    return out


def mesh_phase(train, serve, lm, gm, policy_mod, get_config, serve_argv, card):
    """``[mesh-train]`` and ``[mesh-serve]``: in this process ``train.run``
    on qwen2.5-3b at full width, depth ``MESH_DEPTH``, fp32 with TF32 off,
    B=8 S=128, ``paper_default(0.8)`` with ``--use-pallas``, 3 steps
    (dense, sparse, sparse) at 1x1, and ``serve.run`` at full width,
    depth ``MESH_SERVE_DEPTH``, fp32 and bf16, the ``[serve]`` phase's 8
    Poisson requests (prompt 128, gen 32); then :func:`mesh_ranks` in two
    ranks on the card over gloo.
    Training: the 1x2 and 2x1 losses within ``MESH_LOSS_TOL`` of 1x1's,
    the share of (step, site) kept sets equal to 1x1's, each rank's
    launches equal to the launch table's, every ``matmul`` product within
    ``KERNEL_TOL`` of its plain version, the bf16 1x2 steps' times and
    the probe site's dY equal on both model ranks. Serving on
    ``--model-mesh 2``, fp32 and bf16: each rank launches
    ``paged_attention`` once a layer a step; the share of tokens equal to
    the 1x1 run's of its dtype (fp32 at least ``SHARE_MIN``; bf16
    printed); tokens/s and p50/p99 step. Returns (``matmul``
    launches of the training runs, every rank's; ``paged_attention``
    launches of the mesh serving; the worst product error; the two
    summaries)."""
    from repro_torch.launch.mesh import run_on_mesh

    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=MESH_DEPTH, dtype="float32")
    policy = lm_policy(policy_mod)
    per_step = lm.kernel_launches_per_step(cfg, policy)
    t0 = time.perf_counter()
    for k in gm.launches:
        gm.launches[k] = 0
    one = train.run(train.build_parser().parse_args(_mesh_train_argv(1, 1)), cfg=cfg,
                    collect=("kept",))
    n_sparse = sum(1 for r in one["rates"] if r > 0)
    expect = dict.fromkeys(gm.launches, 0) | {"matmul": per_step["matmul"] * n_sparse}
    if n_sparse != 2 or dict(gm.launches) != expect:
        raise AssertionError(f"[mesh-train] 1x1 launches {dict(gm.launches)} != {expect}")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[mesh-train] {LM_ARCH} full width, depth {MESH_DEPTH}, fp32, B={LM_BATCH} "
          f"S={LM_SEQ}: 1x1 losses {one['history']} in {time.perf_counter() - t0:.1f} s")
    base = dataclasses.replace(get_config(LM_ARCH), n_layers=MESH_SERVE_DEPTH)
    dtypes = ("float32", "bfloat16")
    one_serve = {}
    for dt in dtypes:
        t0 = time.perf_counter()
        one_serve[dt] = serve.run(serve.build_parser().parse_args(serve_argv),
                            cfg=dataclasses.replace(base, dtype=dt))["generated"]
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[mesh-serve] {LM_ARCH} full width, depth {MESH_SERVE_DEPTH}: 1x1 {dt} run "
              f"{time.perf_counter() - t0:.1f} s")

    # [mesh-seq]'s 1x1 run: at a batch --data-mesh 2 does not divide
    t0 = time.perf_counter()
    before = gm.launches["matmul"]
    seq_b, seq_s = MESH_SEQ_LM
    seq_cfg = dataclasses.replace(cfg, n_layers=MESH_SEQ_DEPTH)
    one_seq = {LM_ARCH: train.run(train.build_parser().parse_args(
        _mf_train_argv(LM_ARCH, seq_b, seq_s, 1, 1)), cfg=seq_cfg, collect=("kept",))}
    one_seq_launches = gm.launches["matmul"] - before
    gc.collect()
    torch.cuda.empty_cache()
    t_seq_one = time.perf_counter() - t0
    print(f"[mesh-seq] {LM_ARCH} full width, depth {MESH_SEQ_DEPTH}, fp32, B={seq_b} S={seq_s}: "
          f"1x1 losses {one_seq[LM_ARCH]['history']} in {t_seq_one:.1f} s")

    lock_cfg = dataclasses.replace(base, n_layers=MESH_LOCK_DEPTH, dtype="float32")
    t0 = time.perf_counter()
    one_lock = serve.run(serve.build_parser().parse_args(serve_argv), cfg=lock_cfg)["generated"]
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[mesh-data-serve] {LM_ARCH} full width, depth {MESH_LOCK_DEPTH}: 1x1 float32 run "
          f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    outs, ranks, served, checks, walls, data_served, seq_outs = run_on_mesh(
        mesh_ranks, 1, 2, "cuda", {f"{d}x{m}": _mesh_train_argv(d, m) for d, m in MESH_SHAPES},
        serve_argv + ["--model-mesh", str(MESH_SERVE_MODEL)], cfg,
        [dataclasses.replace(base, dtype=dt) for dt in dtypes], policy, MESH_STEPS, MESH_PROBE,
        serve_argv, lock_cfg, {LM_ARCH: (_mf_train_argv(LM_ARCH, seq_b, seq_s, 2, 1), seq_cfg)},
        timeout_s=MESH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    print(f"[mesh] one spawn of 2 ranks, {wall:.1f} s spawn to exit; rank 0's parts (s): "
          + json.dumps({k: round(v, 1) for k, v in walls.items()}))

    # training
    mesh_launches = expect["matmul"]  # 1x1's, then every rank's
    summary = {"1x1_losses": one["history"]}
    sites = [(st, s) for st in one["kept"] for s in one["kept"][st]]
    for layout, out in outs.items():
        rel = max(abs(a - b) / abs(b) for a, b in zip(out["history"], one["history"], strict=True))
        share = sum(out["kept"][st].get(s) == one["kept"][st][s] for st, s in sites) / len(sites)
        got = [r["matmul"] for r in out["launches_by_rank"]]
        want = [r["matmul"] for r in out["launch_table_by_rank"]]
        if not all(math.isfinite(v) for v in out["history"]) or rel > MESH_LOSS_TOL:
            raise AssertionError(f"[mesh-train] {layout} losses {out['history']} vs 1x1 "
                                 f"{one['history']}: rel {rel:.3g} > {MESH_LOSS_TOL}")
        if got != want or any(sum(v for k, v in r.items() if k != "matmul")
                              for r in out["launches_by_rank"]):
            raise AssertionError(f"[mesh-train] {layout} launches "
                                 f"{out['launches_by_rank']} != the table's {want}")
        mesh_launches += sum(got)
        differ = [f"step {st} {s}: {len(set(out['kept'][st][s]) ^ set(one['kept'][st][s])) // 2} "
                  f"of {len(one['kept'][st][s])} swapped" for st, s in sites
                  if out["kept"][st].get(s) != one["kept"][st][s]]
        summary[layout] = dict(loss_rel=rel, kept_share=share, kept_differ=differ,
                               matmul_by_rank=got, wall_s=walls[layout])
        print(f"[mesh-train] {layout}: losses {out['history']} (max rel {rel:.3g} of 1x1); "
              f"kept sets equal to 1x1's at {share:.4f} of {len(sites)} (step, site), differing "
              f"at {differ}; matmul launches by rank {got} = the table's {want}")
    worst = 0.0
    for r in checks:
        for what, (n, err, limit, miss) in sorted(r["checks"].items()):
            if miss is not None:
                raise AssertionError(f"[mesh-train] rank {r['rank']} {what} matmul {miss}")
            worst = max(worst, err)
        print(f"[mesh-train] rank {r['rank']} matmul products against the plain version on "
              "the same operands (layout dtype: products, max abs err, largest limit): "
              + json.dumps(r["checks"]))
    for r in checks:  # every launch of the fp32 runs and of one bf16 step was checked
        i = r["rank"]
        want = {f"{layout} float32": out["launches_by_rank"][i]["matmul"]
                for layout, out in outs.items()}
        want["1x2 bfloat16"] = outs["1x2"]["launch_table_by_rank"][i]["matmul"] // 2
        got = {w: r["checks"].get(w, [0])[0] for w in want}
        if got != want:
            raise AssertionError(f"[mesh-train] rank {i} products checked {got} != launched {want}")
    summary["matmul_checks"] = {f"rank {r['rank']}": r["checks"] for r in checks}
    seq_launches, seq_err, seq_summary = mesh_seq_report(one_seq, seq_outs, checks,
                                                         one_seq_launches, card)
    summary["seq"] = dict(launches=seq_launches, max_abs_err=seq_err, runs=seq_summary)
    print(f"[time] [mesh-seq] {LM_ARCH}: 1x1 {t_seq_one:.1f} s, 2x1 in the spawn "
          f"{walls[f'seq {LM_ARCH}']:.1f} s")
    for r in ranks:
        if r["dy_spread"] != 0.0:
            raise AssertionError(f"[mesh-train] {MESH_PROBE}'s dY differs over the model ranks "
                                 f"by {r['dy_spread']}")
        print(f"[mesh-train] 1x2 bf16 rank {r['rank']} ({card}): sparse step ms "
              f"{[round(v, 2) for v in r['step_ms']]}, device busy {r['busy_ms']:.2f} ms a step; "
              f"{r['coll_calls']} collectives, {r['coll_bytes'] / 1e6:.1f} MB a step; in a "
              f"second run with each synced, collectives {r['coll_ms']:.2f} ms of a "
              f"{r['synced_step_ms']:.2f} ms step; peak {r['peak_gib']:.2f} GiB; {MESH_PROBE} dY "
              f"spread over model ranks {r['dy_spread']}")
    summary["1x2_bf16"] = ranks

    # serving
    serve_launches, serve_summary = 0, {}
    for dtype, out in zip(dtypes, served, strict=True):
        ref, gen, steps = one_serve[dtype], out["generated"], out["steps"]
        share = float((gen == ref).mean())
        got = [r["paged_attention"] for r in out["launches_by_rank"]]
        if gen.shape != ref.shape or got != [base.n_layers * steps] * MESH_SERVE_MODEL:
            raise AssertionError(f"[mesh-serve] {dtype}: {gen.shape}, launches by rank {got} != "
                                 f"{base.n_layers} x {steps} steps each")
        if dtype == "float32" and share < SHARE_MIN:
            raise AssertionError(f"[mesh-serve] fp32 share {share:.4f} < {SHARE_MIN}")
        ms = np.asarray(out["step_times"]) * 1e3
        st = out["stats"]
        serve_summary[dtype] = dict(share=share, tokens_per_s=st["tokens_per_s"],
                                    generated_per_s=out["tokens_per_s"],
                                    p50_ms=float(np.percentile(ms, 50)),
                                    p99_ms=float(np.percentile(ms, 99)), steps=steps)
        serve_launches += sum(got)
        print(f"[mesh-serve] model={MESH_SERVE_MODEL} {dtype} ({card}): {steps} steps, "
              f"{st['tokens_per_s']:.1f} tokens/s, {out['tokens_per_s']:.1f} generated/s; step p50 "
              f"{serve_summary[dtype]['p50_ms']:.2f} ms p99 {serve_summary[dtype]['p99_ms']:.2f} "
              f"ms; share of tokens equal to 1x1's {share:.4f}; paged_attention launches by rank "
              f"{got} = {base.n_layers} x {steps}")
    serve_summary["wall_s"] = walls["serve"]
    serve_summary["data"] = mesh_data_serve_summary(data_served, one_serve["float32"], one_lock,
                                                    base, walls, card)
    return mesh_launches, serve_launches, worst, summary, serve_summary


def mesh_data_serve_summary(out, ref, lock_ref, cfg, walls, card):
    """``[mesh-data-serve]``'s checks and lines (:func:`mesh_data_serve`'s
    results against the 1x1 fp32 runs' tokens: ``ref`` at ``cfg``'s depth,
    ``lock_ref`` at ``MESH_LOCK_DEPTH``, each the paged engine's). Returns
    its summary, ``launches`` the data-mesh run's ``paged_attention``
    launches over both ranks."""
    run = out["data"]
    gen, steps = run["generated"], run["steps"]
    share = float((gen == ref).mean())
    got = [r["paged_attention"] for r in run["launches_by_rank"]]
    digests = run["pool_digests"]
    if gen.shape != ref.shape or got != [cfg.n_layers * steps] * MESH_DATA:
        raise AssertionError(f"[mesh-data-serve] {gen.shape}, launches by rank {got} != "
                             f"{cfg.n_layers} x {steps} steps each")
    if len(set(digests)) != 1:
        raise AssertionError(f"[mesh-data-serve] the data ranks' pools differ: {digests}")
    if share < SHARE_MIN:
        raise AssertionError(f"[mesh-data-serve] fp32 share {share:.4f} < {SHARE_MIN}")
    ms = np.asarray(run["step_times"]) * 1e3
    st = run["stats"]
    summary = dict(share=share, steps=steps, launches_by_rank=got, launches=sum(got),
                   pool_digest=digests[0], tokens_per_s=st["tokens_per_s"],
                   p50_ms=float(np.percentile(ms, 50)), p99_ms=float(np.percentile(ms, 99)),
                   wall_s=walls["data serve"])
    print(f"[mesh-data-serve] data={MESH_DATA} fp32 ({card}): {steps} steps, "
          f"{st['tokens_per_s']:.1f} tokens/s; step p50 {summary['p50_ms']:.2f} ms p99 "
          f"{summary['p99_ms']:.2f} ms; share of tokens equal to 1x1's {share:.4f}; "
          f"paged_attention launches by rank {got} = {cfg.n_layers} x {steps}; the data ranks' "
          f"pool digests equal ({digests[0][:16]}...); {walls['data serve']:.1f} s")
    for name in MESH_LOCK:
        lock = out[name]
        share = float((lock["generated"] == lock_ref).mean())
        if lock["generated"].shape != lock_ref.shape or share < SHARE_MIN:
            raise AssertionError(f"[mesh-data-serve] lock-step {name}: share {share:.4f} < "
                                 f"{SHARE_MIN} ({lock['generated'].shape})")
        summary[f"lockstep {name}"] = dict(share=share, steps=lock["steps"],
                                           decode_s=lock["decode_s"], prefill_s=lock["prefill_s"],
                                           wall_s=walls[f"lockstep {name}"])
        print(f"[mesh-data-serve] lock-step {name} fp32, depth {MESH_LOCK_DEPTH} ({card}): "
              f"{lock['steps']} steps, prefill {lock['prefill_s']:.1f} s, decode "
              f"{lock['decode_s']:.1f} s; share of tokens equal to the 1x1 paged run's at that "
              f"depth {share:.4f}; {walls[f'lockstep {name}']:.1f} s")
    summary["step"] = out["step"]
    for name, every in out["step"]["ranks"].items():
        print(f"[mesh-data-serve] one lock-step decode step at {name} (depth {MESH_LOCK_DEPTH}, "
              f"B={out['step']['batch']}, {out['step']['max_seq']} tokens, fp32), by rank: "
              + json.dumps(every))
    return summary


# ----------------------------------------------------------------------
# the decoder-only families: mamba2 training and serving, kimi-k2
# serving, the reduced configs of the seven new archs
# ----------------------------------------------------------------------

SSM_ARCH, SSM_BATCH, SSM_SEQ = "mamba2-1.3b", 4, 512  # two 256-token SSD chunks
SSM_SERVE_DEPTH = 2  # [ssm-serve]: 48 layers cut to 2 (the script must end well inside 1200 s)
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
        kept, seen = {}, {}
        for p, s in log:  # a (site, expert) selects once a dispatch group
            n = seen[site_of[p]] = seen.get(site_of[p], -1) + 1
            kept[(*site_of[p], n)] = s.idx
        res[name] = (loss.item(), _named_leaves(grads), kept, float(metrics["aux"]))
        del grads
    expect = lm.kernel_launches_per_step(cfg, kern)["matmul"]
    if launches != expect:
        raise AssertionError(f"{tag}: matmul launches {launches} != launch table {expect}")
    n_sel = sum(cfg.n_experts * max(1, cfg.moe_dp_groups)
                if s.split("/", 1)[1] in EXPERT_SITES else 1 for s in lm.site_names(cfg)[0])
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
    """mamba2-1.3b serves at full width, depth ``SSM_SERVE_DEPTH``: 8 sampled Poisson
    requests (prompt 32 in two 16-token prefill chunks, gen 32) through
    4 slots of the paged engine, the paged engine with a pool small
    enough to swap, speculating 4 tokens self-drafted, the contiguous
    engine and the lock-step baseline, with bf16 params and an fp32 copy. The arch has no
    attention layer, so no kernel runs: the phase holds the engine's SSM
    state (reset, swap, the speculative commit) at full size. The fp32
    shares of tokens equal to the paged run's must reach SHARE_MIN."""
    cfg = dataclasses.replace(get_config(SSM_ARCH), n_layers=SSM_SERVE_DEPTH)
    params = lm.init_params(cfg, 0, "cuda")
    # prompt 32: the per-position recurrence makes a prompt 32 x depth
    # sequential layer steps, the phase's time; two 16-token chunks, so the
    # second starts from the SSM state the first left in the cache
    reqs_kw = dict(n_requests=8, arrival_rate=0.5, prompt_len=32, gen_len=32, seed=0,
                   uniform_prompts=True, **SAMPLED)
    base = dict(max_slots=4, max_seq=64, prefill_chunk=16)
    paged = dict(base, block_size=16)
    runs = {
        "paged": (dict(paged), None),
        "swap": (dict(paged, n_blocks=10, preempt="swap"), None),
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


def moe_serve_phase(lm, pa, S, get_config, serve_cli):
    """kimi-k2-1t-a32b at full width (384 experts, top-8, a shared expert,
    d 7168, 64/8 heads of 112, vocab 163840), depth cut from 61 to 1, bf16
    weights (the experts drawn directly in bf16): 8 requests (prompt 128,
    gen 32) through 4 slots of the paged engine on the kernel route (the
    kernel at head_dim 112) and on the gather route; MoE decode at full
    capacity. The share of tokens equal between the routes must reach
    SHARE_MIN; tokens/s, p50 and p99 step and peak memory printed. Then
    the serving CLI's rank body (``serve_cli.serve_rank``) on the same
    params serves ``[mesh-families]``' workload at 1x1: its tokens are
    returned last, and the params freed."""
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
    before = pa.launches
    mesh_ref = serve_cli.serve_rank(None, serve_cli.build_parser().parse_args(
        _mf_serve_argv(MOE_ARCH, 1)), cfg, params=params)["generated"]
    launches += pa.launches - before
    del params, outs
    gc.collect()
    torch.cuda.empty_cache()
    return launches, dict(summary["kernel"], share=share, peak_gib=peak,
                          gather=summary["gather"], profile=prof), mesh_ref


def families_reduced_phase(lm, steps, backward, policy_mod, pipeline, gm, pa, S, get_config):
    """The reduced fp32 config of each of the seven new archs on the card:
    (i) the training route check (``family_route_check``, B=2 S=24), and
    (ii) 6 sampled requests through the paged engine on
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
        for kind, controls in (("sampled", SAMPLED),):
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
        print(f"[family-serve] {arch} reduced: {len(outs)} runs identical, sampled "
              f"(paged kernel/gather, swap, spec_k={SPEC_K} with a {dcfg.n_layers}-layer "
              f"drafter, contiguous, lock-step) in {time.perf_counter() - t0:.1f} s; first "
              f"streams {first}")
        out[arch] = worst
        del params, dparams
        gc.collect()
        torch.cuda.empty_cache()
    return out

MOE_ARCHS = ("kimi-k2-1t-a32b", "llama4-maverick-400b-a17b", "jamba-1.5-large-398b")
MOE_GROUPS = 2  # [moe-grouped]: the dispatch groups (a mesh's data shards)


def moe_grouped_phase(lm, steps, backward, policy_mod, pipeline, gm, get_config):
    """``[moe-grouped]``: the reduced fp32 MoE configs with
    ``moe_dp_groups=2`` (B=2, S=24: 24 tokens a group), one sparse step
    through ``matmul``, the gather route and the mask oracle
    (:func:`family_route_check`: the same kept channels for every
    (site, expert, group), every leaf within TRAIN_ROUTE_TOL); ``matmul``
    launched the launch table's count, G x experts x products on the
    expert sites and the ungrouped count on the others; then each MoE
    layer's grouped dispatch (``moe_apply``, called on its own) on a
    seeded N(0, 1) input of the step's shape, its ``aux_loss`` and
    ``dropped`` printed. Returns the worst relative L2s and the launches
    of each arch."""
    moe_mod = lm.transformer.moe
    out, launches = {}, {}
    for arch in MOE_ARCHS:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch).reduced(), moe_dp_groups=MOE_GROUPS)
        worst, n = family_route_check(lm, steps, backward, policy_mod, pipeline, gm, cfg, 2, 24,
                                      "[moe-grouped]")
        kern = lm_policy(policy_mod)
        plain = lm.kernel_launches_per_step(dataclasses.replace(cfg, moe_dp_groups=0),
                                            kern)["matmul"]
        n_moe = sum(s.endswith("/moe/gate") for s in lm.site_names(cfg)[0])
        expert = n_moe * 3 * 2 * cfg.n_experts * MOE_GROUPS
        if n != plain + expert * (MOE_GROUPS - 1) // MOE_GROUPS:
            raise AssertionError(f"[moe-grouped] {arch}: matmul {n} != {plain} ungrouped + "
                                 f"{expert * (MOE_GROUPS - 1) // MOE_GROUPS} more expert launches")
        print(f"[moe-grouped] {arch} G={MOE_GROUPS}: matmul launches {n} = {expert} on the "
              f"expert sites ({MOE_GROUPS} x {cfg.n_experts} experts x 3 x 2 products x {n_moe} "
              f"layers) + {n - expert} elsewhere (ungrouped table {plain})")
        params = lm.init_params(cfg, 0, device="cuda")
        metrics = []
        for lp in params["stack"]["layers"]:
            if "moe" in lp:
                gen = torch.Generator(device="cuda").manual_seed(len(metrics))
                x = torch.randn((2, 24, cfg.d_model), generator=gen, device="cuda",
                                dtype=lp["moe"]["gate"].dtype)
                with torch.no_grad():
                    _, m = moe_mod.moe_apply(lp["moe"], x, cfg, kern, dp_groups=MOE_GROUPS)
                metrics.append((round(m["aux_loss"].item(), 6), round(m["dropped"].item(), 6)))
        if len(metrics) != n_moe:
            raise AssertionError(f"[moe-grouped] {arch}: {len(metrics)} MoE layers, "
                                 f"expected {n_moe}")
        print(f"[moe-grouped] {arch}: (aux_loss, dropped) of each MoE layer's grouped dispatch "
              f"on a seeded N(0, 1) input [2, 24, {cfg.d_model}]: {metrics}; "
              f"{time.perf_counter() - t0:.1f} s")
        del params
        out[arch], launches[arch] = worst, n
        gc.collect()
        torch.cuda.empty_cache()
    return out, launches


# ----------------------------------------------------------------------
# the encoder-decoder (whisper-large-v3) and VLM (paligemma-3b) families
# ----------------------------------------------------------------------

ENCDEC_ARCH, VLM_ARCH = "whisper-large-v3", "paligemma-3b"
# training batches: B, S decoder tokens (+ frames [B, 1500, 1280] / patches [B, 256, 2048])
XFAMILY_TRAIN = {ENCDEC_ARCH: (2, 128), VLM_ARCH: (8, 128)}
# the serving phases' depths: whisper's 32 decoder and 32 encoder layers cut
# to 2 each, paligemma's 18 to 2 (the script must end well inside 1200 s)
XFAMILY_SERVE_DEPTH = {ENCDEC_ARCH: 2, VLM_ARCH: 2}
XFAMILY_ROUTE = (2, 32)  # B, S of the route check (full width, depth 2, fp32)
XFAMILY_STEPS = 3  # timed dense and sparse steps each, after a warm-up of each


def xfamily_serve_phase(arch, tag, lm, pa, S, get_config):
    """An encdec or vlm arch serves at full width, depth cut as
    ``XFAMILY_SERVE_DEPTH`` says: 8 sampled
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
    if arch in XFAMILY_SERVE_DEPTH:
        d = XFAMILY_SERVE_DEPTH[arch]
        cfg = dataclasses.replace(cfg, n_layers=d, n_enc_layers=min(cfg.n_enc_layers, d))
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
          f"{peak:.2f} GiB" + (f"; encoder a call (1500 frames, {cfg.n_enc_layers} layers): "
                               f"{json.dumps(enc)}"
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


# ----------------------------------------------------------------------
# the other families on device meshes: mamba2, whisper, paligemma and the
# reduced MoE / hybrid archs train on 1x2 and 2x1; kimi-k2, mamba2,
# whisper and paligemma serve on a model mesh of 2
# ----------------------------------------------------------------------

MF_STEPS = 3  # dense, sparse, sparse (--scheduler bar)
# arch -> (its cut of the full config, B, S); the reduced MoE archs at
# moe_dp_groups 0 and 2 (a full-width kimi-k2 layer's experts are 33.8 GB
# in bf16 before Adam, and jamba is 398 B)
MF_TRAIN = {  # depths cut for the room [mesh-heads] and [fleet-mesh] need
    SSM_ARCH: (dict(n_layers=1), 4, 512),  # 1 of 48 layers (PR 30; 2 before); two SSD chunks
    ENCDEC_ARCH: (dict(n_layers=1, n_enc_layers=1), 2, 128),  # 1 + 1 (PR 30), 1500 frames
    VLM_ARCH: (dict(n_layers=1), 8, 128),  # 1 of 18 layers (PR 30; 2 before), 256 patches
}
MF_REDUCED = ("kimi-k2-1t-a32b", "llama4-maverick-400b-a17b", "jamba-1.5-large-398b")
MF_REDUCED_BS = (8, 64)
MF_GROUPS = (0, 2)
# serving on --model-mesh 2: arch -> (its cut, dtype); 4 Poisson requests,
# prompt 16 (one prefill chunk), gen 16, 4 slots, 16-token pages
MF_SERVE = {  # mamba2 at 1 layer, whisper and paligemma at 2 (the script's time limit)
    MOE_ARCH: (dict(n_layers=MOE_DEPTH), "bfloat16"),  # 192 experts, 4 KV heads a rank
    SSM_ARCH: (dict(n_layers=1), "float32"),
    ENCDEC_ARCH: (dict(n_layers=2, n_enc_layers=2), "float32"),
    VLM_ARCH: (dict(n_layers=2), "float32"),  # the KV head on both
}
MF_TIMEOUT_S = 400
# [mesh-seq] in the same spawn: batches --data-mesh 2 does not divide (data on
# the sequence dim). mamba2 at depth 4, B=1 S=512: one 256-token SSD chunk a
# rank; the reduced MoE archs at moe_dp_groups 0 and 2, B=3 S=64
MF_SEQ = {SSM_ARCH: (dict(n_layers=4), 1, 512),  # 48 layers cut to 4
          # 2 + 2 of 32 + 32, 1500 frames whole on both ranks, 64 tokens a rank
          ENCDEC_ARCH: (dict(n_layers=2, n_enc_layers=2), 1, 128),
          VLM_ARCH: (dict(n_layers=2), 1, 128)}  # 2 of 18; 128 patches, 64 tokens a rank
MF_SEQ_REDUCED_BS = (3, 64)
# a [mesh-seq] run's schedule where it is not --scheduler bar: paligemma's
# three steps all sparse, so that its first sparse step selects from the
# init, alike on both layouts. After bar's dense first step, Adam's eps
# regime (|g| ~ eps: an element moves by lr * g / (|g| + eps)) parts the
# two layouts' params by ~2e-5 relative at its 16384-wide MLP sites, over
# gaps of 4e-6 between the kept and the first dropped channel; every site
# agrees under eps 1e-5 or a sparse first step (tools/seq_split_tie_probe.py)
MF_SEQ_SCHEDULER = {VLM_ARCH: "constant"}


def _mf_train_argv(arch, batch, seq, data, model, scheduler="bar"):
    return ["--arch", arch, "--steps", str(MF_STEPS), "--scheduler", scheduler, "--global-batch",
            str(batch), "--seq-len", str(seq), "--drop-rate", str(LM_RATE), "--granularity",
            "channel", "--use-pallas", "--log-every", "100", "--device", "cuda", "--data-mesh",
            str(data), "--model-mesh", str(model)]


def _mf_serve_argv(arch, model):
    return ["--arch", arch, "--batch", "4", "--requests", "4", "--prompt-len", "16", "--gen",
            "16", "--prefill-chunk", "16", "--block-size", "16", "--arrival-rate", "0.5",
            "--seed", "0", "--device", "cuda", "--model-mesh", str(model)]


def mf_cases(get_config):
    """``{name: (argv maker args, cfg)}`` of the phase's training runs."""
    out = {}
    for arch, (cut, b, sq) in MF_TRAIN.items():
        out[arch] = (arch, b, sq, dataclasses.replace(get_config(arch), dtype="float32", **cut))
    for arch in MF_REDUCED:
        for g in MF_GROUPS:
            out[f"{arch} reduced g{g}"] = (arch, *MF_REDUCED_BS, dataclasses.replace(
                get_config(arch).reduced(), moe_dp_groups=g))
    return out


def mf_seq_cases(get_config):
    """``{name: (arch, B, S, cfg)}`` of ``[mesh-seq]``'s family runs."""
    out = {}
    for arch, (cut, b, sq) in MF_SEQ.items():
        out[arch] = (arch, b, sq, dataclasses.replace(get_config(arch), dtype="float32", **cut))
    for arch in MF_REDUCED:
        for g in MF_GROUPS:
            out[f"{arch} reduced g{g}"] = (arch, *MF_SEQ_REDUCED_BS, dataclasses.replace(
                get_config(arch).reduced(), moe_dp_groups=g))
    return out


def matmul_checker(checks, gm):
    """``checker(what)``: an ``observe_matmul`` callback that holds each
    ``matmul`` launch's output to the plain version on its own operands
    within ``KERNEL_TOL`` x max(1, max|plain|), counting into
    ``checks[what]`` = [products, worst error, largest limit, first miss]."""
    def checker(what):
        def check(a, b, out):
            ref = gm.matmul_ref(a, b)
            err = (out - ref).abs().max().item()
            limit = KERNEL_TOL * max(1.0, ref.abs().max().item())
            c = checks.setdefault(what, [0, 0.0, 0.0, None])
            c[0] += 1
            c[1] = max(c[1], err)
            c[2] = max(c[2], limit)
            if err > limit and c[3] is None:
                c[3] = f"A{tuple(a.shape)} @ B{tuple(b.shape)}: {err} > {limit}"
        return check
    return checker


def mesh_family_ranks(mesh, cases, serves, seq_cases):
    """Every mesh run of ``[mesh-families]`` in one spawn of two ranks on
    the card: the training CLI's rank body (``train.run_rank``, the kept
    channels collected) once a case of ``cases`` (``{name: (argv by
    layout, cfg)}``) on this 1x2 mesh and on a 2x1 mesh over the same
    ranks, every ``matmul`` launch held to its plain version on the same
    operands (``gathered_matmul.observe_matmul``); then the serving CLI's
    rank body once a config of ``serves`` (``{name: (argv, cfg)}``) on
    the 1x2 mesh, the collectives' calls and bytes counted; then
    :func:`mesh_seq_ranks` of ``seq_cases`` on the 2x1 mesh. Returns (rank
    0's training dicts, its serving dicts, every rank's product checks
    and collectives, rank 0's wall a part, the ``[mesh-seq]`` runs)."""
    import torch.distributed as dist

    from repro_torch.dist import parallel
    from repro_torch.kernels import gathered_matmul as gm
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import serve, train

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain products in full fp32
    torch.backends.cudnn.allow_tf32 = False
    checks = {}  # case -> [products, worst error, largest limit, first miss]
    checker = matmul_checker(checks, gm)

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    walls, trained, served, colls = {}, {}, {}, {}
    m21 = mesh_lib.make_host_mesh(2, 1, "cuda")
    for name, (argvs, cfg) in cases.items():
        for layout, argv in argvs.items():
            t0 = time.perf_counter()
            with gm.observe_matmul(checker(f"{name} {layout}")):
                trained[name, layout] = train.run_rank(
                    mesh if layout == "1x2" else m21, train.build_parser().parse_args(argv),
                    cfg, ("kept",))
            free()
            walls[f"{name} {layout}"] = time.perf_counter() - t0
            if mesh.rank == 0:
                print(f"[mesh-families] rank 0: {name} {layout} in "
                      f"{walls[f'{name} {layout}']:.1f} s", flush=True)
    for name, (argv, cfg) in serves.items():
        t0 = time.perf_counter()
        parallel.counters.update(calls=0, bytes=0, s=0.0)
        served[name] = serve.serve_rank(mesh, serve.build_parser().parse_args(argv), cfg)
        colls[name] = dict(parallel.counters)
        free()
        walls[f"serve {name}"] = time.perf_counter() - t0
        if mesh.rank == 0:
            print(f"[mesh-families] rank 0: serve {name} in {walls[f'serve {name}']:.1f} s",
                  flush=True)
    seq_outs, seq_walls = mesh_seq_ranks(m21, seq_cases, checker, free)
    walls.update(seq_walls)
    every = [None] * mesh.world
    dist.all_gather_object(every, {"rank": mesh.rank, "checks": checks, "colls": colls})
    return trained, served, every, walls, seq_outs


def mesh_families_phase(train, serve, lm, gm, pa, get_config, kimi_one, card):
    """``[mesh-families]``: in this process ``train.run`` of every case of
    :func:`mf_cases` at 1x1 (fp32, TF32 off, ``paper_default(0.8)`` with
    ``--use-pallas``, 3 steps: dense, sparse, sparse; whisper's frames and
    paligemma's patches from the pipeline's ``frontend_inputs``) and
    ``serve.run`` of mamba2, whisper and paligemma at 1x1 (kimi-k2's 1x1
    streams are ``kimi_one``, from ``[moe-serve]``, its weights freed);
    then :func:`mesh_family_ranks` in two ranks on the card over gloo.
    Training: the 1x2 and 2x1 losses within ``MESH_LOSS_TOL`` of 1x1's,
    the share of (step, site) kept sets equal to 1x1's (a routed expert's
    sites its own), each rank's ``matmul`` launches equal to the launch
    table's, every product within ``KERNEL_TOL`` of its plain version.
    Serving on ``--model-mesh 2``: each rank's ``paged_attention``
    launches (an attention layer a step), the share of tokens equal to
    1x1's (fp32 at least ``SHARE_MIN``; kimi-k2's bf16 printed),
    tokens/s, p50/p99 step and the collectives' calls and bytes a step.
    Returns (``matmul`` launches, every run's and rank's;
    ``paged_attention`` launches; the worst product error; a summary)."""
    from repro_torch.launch.mesh import run_on_mesh

    t_phase = time.perf_counter()
    cases = mf_cases(get_config)
    one, mm_launches = {}, 0
    for name, (arch, b, sq, cfg) in cases.items():
        before = gm.launches["matmul"]
        one[name] = train.run(train.build_parser().parse_args(_mf_train_argv(arch, b, sq, 1, 1)),
                              cfg=cfg, collect=("kept",))
        n = gm.launches["matmul"] - before
        mm_launches += n
        if n != one[name]["launches"]["matmul"] or not n:
            raise AssertionError(f"[mesh-families] {name} 1x1: matmul launches {n}")
        gc.collect()
        torch.cuda.empty_cache()
    t_one = time.perf_counter() - t_phase
    serves, serve_one, pa_launches = {}, {}, 0
    for arch, (cut, dtype) in MF_SERVE.items():
        cfg = dataclasses.replace(get_config(arch), dtype=dtype, **cut)
        serves[arch] = (_mf_serve_argv(arch, 2), cfg)
        if arch == MOE_ARCH:
            serve_one[arch] = kimi_one
            continue
        before = pa.launches
        serve_one[arch] = serve.run(serve.build_parser().parse_args(_mf_serve_argv(arch, 1)),
                                    cfg=cfg)["generated"]
        pa_launches += pa.launches - before
        gc.collect()
        torch.cuda.empty_cache()
    t_one_serve = time.perf_counter() - t_phase - t_one
    print(f"[mesh-families] 1x1: {len(cases)} training runs in {t_one:.1f} s, "
          f"{len(serve_one) - 1} serving runs in {t_one_serve:.1f} s")
    # [mesh-seq]'s 1x1 runs: each case at its batch, depth and seed
    t0 = time.perf_counter()
    seq_cases, one_seq, one_seq_launches = mf_seq_cases(get_config), {}, 0
    for name, (arch, b, sq, cfg) in seq_cases.items():
        before = gm.launches["matmul"]
        one_seq[name] = train.run(train.build_parser().parse_args(
            _mf_train_argv(arch, b, sq, 1, 1, MF_SEQ_SCHEDULER.get(name, "bar"))), cfg=cfg,
            collect=("kept",))
        one_seq_launches += gm.launches["matmul"] - before
        gc.collect()
        torch.cuda.empty_cache()
    t_seq_one = time.perf_counter() - t0
    print(f"[mesh-seq] 1x1: {len(seq_cases)} family runs in {t_seq_one:.1f} s")

    t0 = time.perf_counter()
    seq_argvs = {name: (_mf_train_argv(arch, b, sq, 2, 1, MF_SEQ_SCHEDULER.get(name, "bar")), cfg)
                 for name, (arch, b, sq, cfg) in seq_cases.items()}
    trained, served, every, walls, seq_outs = run_on_mesh(
        mesh_family_ranks, 1, 2, "cuda",
        {name: ({f"{d}x{m}": _mf_train_argv(arch, b, sq, d, m) for d, m in MESH_SHAPES}, cfg)
         for name, (arch, b, sq, cfg) in cases.items()},
        serves, seq_argvs, timeout_s=MF_TIMEOUT_S)
    wall = time.perf_counter() - t0
    print(f"[mesh-families] one spawn of 2 ranks, {wall:.1f} s spawn to exit; rank 0's parts "
          "(s): " + json.dumps({k: round(v, 1) for k, v in walls.items()}))

    summary, worst = {}, 0.0
    for (name, layout), out in trained.items():
        ref = one[name]
        rel = max(abs(a - b) / abs(b) for a, b in zip(out["history"], ref["history"], strict=True))
        sites = [(st, si) for st in ref["kept"] for si in ref["kept"][st]]
        share = sum(out["kept"][st].get(si) == ref["kept"][st][si] for st, si in sites) / len(sites)
        got = [r["matmul"] for r in out["launches_by_rank"]]
        want = [r["matmul"] for r in out["launch_table_by_rank"]]
        if not all(math.isfinite(v) for v in out["history"]) or rel > MESH_LOSS_TOL:
            raise AssertionError(f"[mesh-families] {name} {layout} losses {out['history']} vs "
                                 f"1x1 {ref['history']}: rel {rel:.3g} > {MESH_LOSS_TOL}")
        if got != want or not all(got) or any(sum(v for k, v in r.items() if k != "matmul")
                                              for r in out["launches_by_rank"]):
            raise AssertionError(f"[mesh-families] {name} {layout} launches "
                                 f"{out['launches_by_rank']} != the table's {want}")
        mm_launches += sum(got)
        # a differing set: how many of its kept channels are swapped
        swapped = {f"{st} {si}": (len(set(out["kept"][st].get(si, ())) - set(ref["kept"][st][si])),
                                  len(ref["kept"][st][si]))
                   for st, si in sites if out["kept"][st].get(si) != ref["kept"][st][si]}
        frac = max((n / max(k, 1) for n, k in swapped.values()), default=0.0)
        summary[f"{name} {layout}"] = dict(loss_rel=rel, kept_share=share, matmul_by_rank=got,
                                           most_swapped=frac, wall_s=walls[f"{name} {layout}"])
        worst_sets = sorted(swapped.items(), key=lambda kv: -kv[1][0] / max(kv[1][1], 1))[:3]
        print(f"[mesh-families] {name} {layout}: losses {out['history']} (max rel {rel:.3g} of "
              f"1x1 {ref['history']}); kept sets equal to 1x1's at {share:.4f} of {len(sites)} "
              f"(step, site), at most {frac:.4f} of a set's channels swapped "
              f"({', '.join(f'{k}: {n} of {c}' for k, (n, c) in worst_sets)}); matmul launches "
              f"by rank {got} = the table's")
    for r in every:
        for what, (n, err, limit, miss) in sorted(r["checks"].items()):
            if miss is not None:
                raise AssertionError(f"[mesh-families] rank {r['rank']} {what} matmul {miss}")
            worst = max(worst, err)
        for (name, layout), out in trained.items():
            n = r["checks"].get(f"{name} {layout}", [0])[0]
            if n != out["launches_by_rank"][r["rank"]]["matmul"]:
                raise AssertionError(f"[mesh-families] rank {r['rank']} {name} {layout}: "
                                     f"{n} products checked of "
                                     f"{out['launches_by_rank'][r['rank']]['matmul']} launched")
    print(f"[mesh-families] every matmul product of both ranks within {KERNEL_TOL} x max(1, "
          f"max|plain|) of its plain version: {sum(c[0] for r in every for c in r['checks'].values())} "
          f"products, worst {worst:.3g}")

    serve_summary = {}
    for arch, out in served.items():
        cfg = serves[arch][1]
        gen, steps, ref = out["generated"], out["steps"], serve_one[arch]
        share = float((gen == ref).mean()) if gen.shape == ref.shape else 0.0
        n_attn = (cfg.n_layers if cfg.family == "encdec" else
                  sum(1 for s in lm.transformer.layer_slots(cfg) if s.mixer == "attn"))
        got = [r["paged_attention"] for r in out["launches_by_rank"]]
        if gen.shape != ref.shape or got != [n_attn * steps] * 2:
            raise AssertionError(f"[mesh-families] serve {arch}: {gen.shape} vs {ref.shape}, "
                                 f"paged_attention by rank {got} != {n_attn} x {steps}")
        if cfg.dtype == "float32" and share < SHARE_MIN:
            raise AssertionError(f"[mesh-families] serve {arch} fp32 share {share:.4f} < "
                                 f"{SHARE_MIN}")
        pa_launches += sum(got)
        ms = np.asarray(out["step_times"]) * 1e3
        st = out["stats"]
        coll = [r["colls"][arch] for r in every]
        serve_summary[arch] = dict(
            dtype=cfg.dtype, share=share, steps=steps, tokens_per_s=st["tokens_per_s"],
            generated_per_s=out["tokens_per_s"], p50_ms=float(np.percentile(ms, 50)),
            p99_ms=float(np.percentile(ms, 99)), paged_attention_by_rank=got,
            collectives_per_step=[c["calls"] / steps for c in coll],
            collective_mb_per_step=[c["bytes"] / steps / 1e6 for c in coll],
            wall_s=walls[f"serve {arch}"])
        print(f"[mesh-families] serve {arch} (depth {cfg.n_layers}, {cfg.dtype}) on "
              f"--model-mesh 2 ({card}): {steps} steps, {st['tokens_per_s']:.1f} tokens/s, "
              f"{out['tokens_per_s']:.1f} generated/s; step p50 "
              f"{serve_summary[arch]['p50_ms']:.2f} ms p99 {serve_summary[arch]['p99_ms']:.2f} "
              f"ms; share of tokens equal to 1x1's {share:.4f}; paged_attention by rank {got}; "
              f"collectives a step by rank {serve_summary[arch]['collectives_per_step']}, MB "
              f"{[round(v, 2) for v in serve_summary[arch]['collective_mb_per_step']]}")
    seq_launches, seq_err, seq_summary = mesh_seq_report(one_seq, seq_outs, every,
                                                         one_seq_launches, card)
    print(f"[time] [mesh-seq] the families: 1x1 {t_seq_one:.1f} s, 2x1 in the spawn "
          f"{sum(v for k, v in walls.items() if k.startswith('seq ')):.1f} s")
    total = time.perf_counter() - t_phase
    print(f"[mesh-families] phase {total:.1f} s ({card})")
    return mm_launches, pa_launches, worst, dict(
        train=summary, serve=serve_summary, spawn_s=wall, phase_s=total,
        seq=dict(launches=seq_launches, max_abs_err=seq_err, runs=seq_summary))


# ----------------------------------------------------------------------
# [mesh-heads]: model meshes that do not divide the q heads
# ----------------------------------------------------------------------

MH_STEPS = 3  # dense, sparse, sparse (--scheduler bar)
# name -> (arch, the cut of its config, B, S, --model-mesh). whisper at full
# width on 8 ranks: 160 of its 1280 q columns a rank, 2.5 of its 20 heads
# of 64, the 20 KV heads neither dividing 8 nor divided by it; 1 + 1 of
# 32 + 32 layers, 1500 stub frames. The reduced configs whose head
# overrides give llama4-maverick's (3 q heads on one KV head) and
# paligemma's (half a head) spans at --model-mesh 16, on 4 ranks
MH_CASES = {
    ENCDEC_ARCH: (ENCDEC_ARCH, dict(n_layers=1, n_enc_layers=1), 2, 128, 8),  # PR 30: 2 + 2
    "llama4-like": ("llama4-maverick-400b-a17b", dict(n_heads=10, n_kv_heads=2), 8, 64, 4),
    "paligemma-like": (VLM_ARCH, dict(n_heads=2, n_kv_heads=1), 8, 64, 4),
}
MH_TIMEOUT_S = 400


def mh_config(get_config, name):
    """A ``[mesh-heads]`` case's config (fp32): whisper cut in depth, the
    others reduced with their head overrides."""
    arch, cut, *_ = MH_CASES[name]
    if name == arch:
        return dataclasses.replace(get_config(arch), dtype="float32", **cut)
    return dataclasses.replace(get_config(arch).reduced(), **cut)


def mesh_heads_ranks(mesh, cases):
    """The ranks' part of ``[mesh-heads]`` in one spawn on the card: once
    a case of ``cases`` (``{name: (train argv, serve argv, cfg)}``) the
    training CLI's rank body (``train.run_rank``, the kept channels
    collected), every ``matmul`` launch held to its plain version on its
    own operands (``gathered_matmul.observe_matmul``), then the serving
    CLI's rank body, the collectives' calls and bytes counted; each run's
    kernel counts set to 0 just before it and read just after. Returns
    (rank 0's training dicts, its serving dicts, every rank's product
    checks and collectives, rank 0's wall a part)."""
    import torch.distributed as dist

    from repro_torch.dist import parallel
    from repro_torch.kernels import gathered_matmul as gm
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch import serve, train

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain products in full fp32
    torch.backends.cudnn.allow_tf32 = False
    checks, colls, walls, trained, served = {}, {}, {}, {}, {}
    checker = matmul_checker(checks, gm)

    for name, (train_argv, serve_argv, cfg) in cases.items():
        t0 = time.perf_counter()
        for k in gm.launches:
            gm.launches[k] = 0
        with gm.observe_matmul(checker(name)):
            trained[name] = dict(train.run_rank(mesh, train.build_parser().parse_args(train_argv),
                                                cfg, ("kept",)), counted=dict(gm.launches))
        gc.collect()
        torch.cuda.empty_cache()
        walls[f"train {name}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pa.launches = 0
        parallel.counters.update(calls=0, bytes=0, s=0.0)
        served[name] = dict(serve.serve_rank(mesh, serve.build_parser().parse_args(serve_argv),
                                             cfg), counted=pa.launches)
        colls[name] = dict(parallel.counters)
        gc.collect()
        torch.cuda.empty_cache()
        walls[f"serve {name}"] = time.perf_counter() - t0
        if mesh.rank == 0:
            print(f"[mesh-heads] rank 0: {name} on 1x{mesh.model}: training "
                  f"{walls[f'train {name}']:.1f} s, serving {walls[f'serve {name}']:.1f} s",
                  flush=True)
    every = [None] * mesh.world
    dist.all_gather_object(every, {"rank": mesh.rank, "checks": checks, "colls": colls})
    return trained, served, every, walls


def mesh_heads_phase(train, serve, lm, gm, pa, get_config, card):
    """``[mesh-heads]``: each case of ``MH_CASES`` trains (fp32, TF32 off,
    ``paper_default(0.8)`` with ``--use-pallas``, 3 steps: dense, sparse,
    sparse; whisper's frames from the pipeline's ``frontend_inputs``) and
    serves (4 Poisson requests, prompt 16, gen 16, fp32) at 1x1 in this
    process, then on ``1 x --model-mesh`` in a spawn of that many rank
    processes on the card over gloo (:func:`mesh_heads_ranks`): each rank
    runs the q heads its columns touch (``models/layers.py::head_span``).
    Training: losses within ``MESH_LOSS_TOL`` of 1x1's, the first sparse
    step's kept sets equal to 1x1's at every site (the share over every
    step printed), each rank's ``matmul`` launches equal to the launch
    table's and to its own count from 0, every launch within
    ``KERNEL_TOL`` of its plain version. Serving: the share of tokens
    equal to 1x1's 1.0, each rank's ``paged_attention`` launches an
    attention layer a step (every rank has a span), the collectives a
    step. Returns (``matmul`` launches, ``paged_attention`` launches, the
    worst product error, a summary)."""
    from repro_torch.launch.mesh import run_on_mesh
    from repro_torch.models import layers

    t_phase = time.perf_counter()
    cfgs = {name: mh_config(get_config, name) for name in MH_CASES}
    argv = {}
    for name, (arch, _, b, sq, m) in MH_CASES.items():
        argv[name] = {layout: (_mf_train_argv(arch, b, sq, 1, model), _mf_serve_argv(arch, model))
                      for layout, model in (("1x1", 1), ("mesh", m))}
    one, mm_launches, pa_launches = {}, 0, 0
    for name, cfg in cfgs.items():
        before = gm.launches["matmul"]
        one[name] = train.run(train.build_parser().parse_args(argv[name]["1x1"][0]), cfg=cfg,
                              collect=("kept",))
        n = gm.launches["matmul"] - before
        if n != one[name]["launches"]["matmul"] or not n:
            raise AssertionError(f"[mesh-heads] {name} 1x1: matmul launches {n}")
        mm_launches += n
        before = pa.launches
        one[name]["generated"] = serve.run(serve.build_parser().parse_args(argv[name]["1x1"][1]),
                                           cfg=cfg)["generated"]
        pa_launches += pa.launches - before
        gc.collect()
        torch.cuda.empty_cache()
    t_one = time.perf_counter() - t_phase
    print(f"[mesh-heads] 1x1: {len(cfgs)} training and serving runs in {t_one:.1f} s")

    trained, served, every, walls, spawns = {}, {}, [], {}, {}
    for m in sorted({c[4] for c in MH_CASES.values()}, reverse=True):
        t0 = time.perf_counter()
        cases = {name: (*argv[name]["mesh"], cfgs[name]) for name, c in MH_CASES.items()
                 if c[4] == m}
        tr, sv, ev, wl = run_on_mesh(mesh_heads_ranks, 1, m, "cuda", cases,
                                     timeout_s=MH_TIMEOUT_S)
        trained.update(tr)
        served.update(sv)
        every.append(ev)
        walls.update(wl)
        spawns[f"1x{m}"] = time.perf_counter() - t0
        print(f"[mesh-heads] one spawn of {m} ranks, {spawns[f'1x{m}']:.1f} s spawn to exit; "
              "rank 0's parts (s): " + json.dumps({k: round(v, 1) for k, v in wl.items()}),
              flush=True)

    summary, worst = {}, 0.0
    for name, out in trained.items():
        ref, cfg, m = one[name], cfgs[name], MH_CASES[name][4]
        spans = [layers.head_span(cfg, m, r) for r in range(m)]
        rel = max(abs(a - b) / abs(b) for a, b in zip(out["history"], ref["history"], strict=True))
        first = min(st for st, v in ref["kept"].items() if v)  # the first sparse step
        differ = sorted(s for s, v in ref["kept"][first].items()
                        if out["kept"][first].get(s) != v)
        sites = [(st, si) for st in ref["kept"] for si in ref["kept"][st]]
        share = sum(out["kept"][st].get(si) == ref["kept"][st][si] for st, si in sites) / len(sites)
        got = [r["matmul"] for r in out["launches_by_rank"]]
        want = [r["matmul"] for r in out["launch_table_by_rank"]]
        ranks_of = next(ev for ev in every if len(ev) == m)
        checked = [r["checks"].get(name, [0, 0.0, 0.0, None]) for r in ranks_of]
        if not all(math.isfinite(v) for v in out["history"]) or rel > MESH_LOSS_TOL:
            raise AssertionError(f"[mesh-heads] {name} losses {out['history']} vs 1x1 "
                                 f"{ref['history']}: rel {rel:.3g} > {MESH_LOSS_TOL}")
        if differ:
            raise AssertionError(f"[mesh-heads] {name}: the first sparse step's kept sets "
                                 f"differ from 1x1's at {differ}")
        others = sum(v for r in out["launches_by_rank"] for k, v in r.items() if k != "matmul")
        if got != want or not all(got) or others or out["counted"]["matmul"] != got[0]:
            raise AssertionError(f"[mesh-heads] {name} launches {out['launches_by_rank']} "
                                 f"(rank 0 counted {out['counted']}) != the table's {want}")
        if [c[0] for c in checked] != got or any(c[3] for c in checked):
            raise AssertionError(f"[mesh-heads] {name}: products checked {checked} of {got}")
        worst = max([worst] + [c[1] for c in checked])
        mm_launches += sum(got)
        sv = served[name]
        gen, steps = sv["generated"], sv["steps"]
        tok_share = float((gen == ref["generated"]).mean()) if gen.shape == ref[
            "generated"].shape else 0.0
        n_attn = (cfg.n_layers if cfg.family == "encdec" else
                  sum(1 for s in lm.transformer.layer_slots(cfg) if s.mixer == "attn"))
        pa_got = [r["paged_attention"] for r in sv["launches_by_rank"]]
        if tok_share != 1.0:
            raise AssertionError(f"[mesh-heads] serve {name}: share of tokens equal to 1x1's "
                                 f"{tok_share:.4f} != 1.0")
        if pa_got != [n_attn * steps] * m or sv["counted"] != pa_got[0]:
            raise AssertionError(f"[mesh-heads] serve {name}: paged_attention by rank {pa_got} "
                                 f"(rank 0 counted {sv['counted']}) != {n_attn} x {steps}")
        pa_launches += sum(pa_got)
        coll = [r["colls"][name] for r in ranks_of]
        ms = np.asarray(sv["step_times"]) * 1e3
        summary[name] = dict(
            model=m, spans=[[s.q, s.kv] for s in spans], losses=out["history"], loss_rel=rel,
            first_sparse_step=first, kept_sites=len(ref["kept"][first]), kept_share=share,
            matmul_by_rank=got, products_worst=max(c[1] for c in checked), share=tok_share,
            steps=steps, paged_attention_by_rank=pa_got, tokens_per_s=sv["stats"]["tokens_per_s"],
            p50_ms=float(np.percentile(ms, 50)), p99_ms=float(np.percentile(ms, 99)),
            collectives_per_step=[c["calls"] / steps for c in coll],
            collective_mb_per_step=[c["bytes"] / steps / 1e6 for c in coll],
            train_s=walls[f"train {name}"], serve_s=walls[f"serve {name}"])
        print(f"[mesh-heads] {name} (depth {cfg.n_layers}, {cfg.n_heads} q heads on "
              f"{cfg.n_kv_heads} KV heads of {cfg.head_dim}) on 1x{m} ({card}): spans (q, KV) "
              f"{summary[name]['spans']}; losses {out['history']} (max rel {rel:.3g} of 1x1 "
              f"{ref['history']}); first sparse step {first}: kept sets equal to 1x1's at all "
              f"{len(ref['kept'][first])} sites ({share:.4f} of every (step, site)); matmul "
              f"launches by rank {got} = the table's, every product within {KERNEL_TOL} x "
              f"max(1, max|plain|) of the plain version (worst "
              f"{summary[name]['products_worst']:.3g}); serving: {steps} steps, share of "
              f"tokens equal to 1x1's {tok_share:.4f}, paged_attention by rank {pa_got} = "
              f"{n_attn} x {steps}, {summary[name]['tokens_per_s']:.1f} tokens/s, p50 "
              f"{summary[name]['p50_ms']:.2f} ms p99 {summary[name]['p99_ms']:.2f} ms, "
              f"collectives a step by rank {summary[name]['collectives_per_step']}, MB "
              f"{[round(v, 3) for v in summary[name]['collective_mb_per_step']]}", flush=True)
    total = time.perf_counter() - t_phase
    print(f"[time] [mesh-heads] 1x1 {t_one:.1f} s, spawns "
          f"{json.dumps({k: round(v, 1) for k, v in spawns.items()})}, phase {total:.1f} s",
          flush=True)
    return mm_launches, pa_launches, worst, dict(cases=summary, spawn_s=spawns, phase_s=total)


# ----------------------------------------------------------------------
# the program auditor and the dry run, held to the card
# ----------------------------------------------------------------------

AUDIT_KERNELS = ("paged_attention", "dx_gathered", "dw_gathered", "conv_dw_fused",
                 "conv_dx_fused", "matmul", "importance")


class LaunchLog:
    """Every distinct launch (kernel, its C entry point's integer
    arguments) this process makes, with its count."""

    def __init__(self):
        self.seen: dict[tuple, int] = {}

    def add(self, name, args) -> None:
        key = (name, tuple(int(a) for a in args))
        self.seen[key] = self.seen.get(key, 0) + 1


def synced_step(fn, args, gm):
    """``fn(*args)`` under ``torch.cuda.set_sync_debug_mode("warn")``:
    returns its output, the synchronizing-operation warnings it raised and
    the wrappers' launches it made."""
    import warnings

    from repro_torch.launch.graphs import launch_counts

    torch.cuda.synchronize()
    before = launch_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    after = launch_counts()
    launched = {k: after[k] - before[k] for k in before if after[k] != before[k]}
    return out, syncs, launched


def audit_phase(log, gm, get_config, lm, lm_steps, tc, resnet, adam, policy_mod, card):
    """``[audit]`` (module docstring, 23b). Returns its summary."""
    from repro_torch.analysis import dispatch_walk, launch_check, savings
    from repro_torch.analysis.report import Report
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import input_specs
    from repro_torch.kernels import specs

    t0 = time.perf_counter()
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    label = f"the card's opt-in limit ({card})"
    by_kernel: dict[str, dict] = {}
    for (name, args), count in sorted(log.seen.items()):
        sp = specs.spec_for_launch(name, args)
        got = gm.geometry(name, args)
        if got != sp.geometry():
            raise AssertionError(f"[audit] {name}{args}: <name>_geometry {got} != specs.py "
                                 f"{sp.geometry()}")
        rep = Report(name)
        if not launch_check.check_spec(rep, sp, limit=limit, label=label, traffic=False):
            raise AssertionError(f"[audit] {name}{args}: "
                                 + "; ".join(f.message for f in rep.errors()))
        k = by_kernel.setdefault(name, {"launch_shapes": 0, "launches": 0, "smem_max": 0,
                                        "top": None})
        k["launch_shapes"] += 1
        k["launches"] += count
        k["smem_max"] = max(k["smem_max"], sp.shared_bytes)
        if k["top"] is None or sp.useful_flops > k["top"][1].useful_flops:
            k["top"] = (args, sp)
    missing = [n for n in AUDIT_KERNELS if n not in by_kernel]
    if missing:
        raise AssertionError(f"[audit] no launch of {missing} was seen")
    summary = {"smem_limit": limit, "checked_s": 0.0, "kernels": {}}
    for name in AUDIT_KERNELS:
        k = by_kernel[name]
        args, sp = k["top"]
        moved = specs.emulate_bytes(sp)
        row = dict(launch_shapes=k["launch_shapes"], launches=k["launches"],
                   smem_max=k["smem_max"], top_args=list(args), geometry=list(sp.geometry()),
                   tile=list(sp.tile), stages=sp.stages, split=sp.split,
                   tile_flops=sp.tile_flops, product_flops=sp.product_flops,
                   useful_flops=sp.useful_flops, emulated_bytes=moved,
                   least_bytes=sp.least_bytes, traffic_ratio=moved / sp.least_bytes)
        summary["kernels"][name] = row
        print(f"[audit] {name}: {k['launch_shapes']} launch shapes ({k['launches']} launches) "
              f"in this process, each <name>_geometry = specs.py's and in bounds; shared "
              f"memory at most {k['smem_max']} B of {limit} B; largest launch {list(args)}: "
              f"grid {sp.launches[0].grid} block {sp.launches[0].block} smem "
              f"{sp.launches[0].smem} split {sp.split} stages {sp.stages}; tile FLOPs "
              f"{sp.tile_flops} / useful {sp.useful_flops}; bytes moved {moved} / least "
              f"{sp.least_bytes} = {moved / sp.least_bytes:.3f}", flush=True)
    summary["checked_s"] = time.perf_counter() - t0

    # host syncs and launches of two sparse steps, on the card and in the census
    steps_out = {}
    rpol = train_policy(policy_mod)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = resnet.init_params(RESNET, 0, device="cuda")
    opt = adam.init(params)
    x = torch.randn((TRAIN_BATCH, *TRAIN_IMAGE), generator=gen, device="cuda")
    y = torch.randint(0, 10, (TRAIN_BATCH,), generator=gen, device="cuda")
    ocfg = adam.AdamConfig()
    cases = {f"{RESNET} B={TRAIN_BATCH}": (
        lambda p, o, a, b: tc.train_step(RESNET, p, o, a, b, rpol, ocfg), (params, opt, x, y))}
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=LM_ROUTE_DEPTH, dtype="float32")
    lparams = lm.init_params(cfg, 0, device="cuda")
    lopt = adam.init(lparams)
    batch = {k: torch.randint(0, cfg.vocab, v.shape, generator=gen, device="cuda",
                              dtype=v.dtype)
             for k, v in input_specs(cfg, ShapeConfig("audit", LM_SEQ, LM_BATCH, "train")).items()}
    lfn = lm_steps.make_train_step(cfg, lm_policy(policy_mod), adam.AdamConfig())
    cases[f"{LM_ARCH} depth {LM_ROUTE_DEPTH}"] = (lfn, (lparams, lopt, batch))
    # the reduced kimi-k2: the MoE dispatch's data-dependent shapes stall the host
    mcfg = get_config(MOE_ARCH).reduced()
    mparams = lm.init_params(mcfg, 0, device="cuda")
    mbatch = {k: torch.randint(0, mcfg.vocab, v.shape, generator=gen, device="cuda",
                               dtype=v.dtype)
              for k, v in input_specs(mcfg, ShapeConfig("audit", 64, LM_BATCH, "train")).items()}
    cases[f"{MOE_ARCH} reduced"] = (
        lm_steps.make_train_step(mcfg, lm_policy(policy_mod), adam.AdamConfig()),
        (mparams, adam.init(mparams), mbatch))
    # the steps that run captured: none may stall the host
    cases[f"{RESNET} B={TRAIN_BATCH} in-place (captured)"] = (
        lambda p, o, a, b: lm_steps.make_inplace_step(
            lambda q, pol, u, w: tc.loss_fn(RESNET, q, u, w, pol), p, o, ocfg,
            lambda _: rpol)(LM_RATE, a, b),
        (resnet.init_params(RESNET, 0, device="cuda"), adam.init(params), x, y))
    from repro_torch.models import ddpm

    dparams = ddpm.init_params(0, channels=DDPM_IMAGE[0], base=DDPM_BASE, t_dim=DDPM_TDIM,
                               device="cuda")
    dsched = ddpm.make_schedule(DDPM_T, device="cuda")
    dx0 = torch.randn((16, *DDPM_IMAGE), generator=gen, device="cuda")
    dpol = ddpm_policy(policy_mod)
    cases[f"ddpm base {DDPM_BASE} B=16 in-place (captured)"] = (
        lambda p, o, sc, a, t, n: lm_steps.make_inplace_step(
            lambda q, pol, u, v, w: ddpm.loss_fn(q, sc, u, v, w, pol), p, o, adam.adamw(),
            lambda _: dpol)(LM_RATE, a, t, n),
        (dparams, adam.init(dparams), dsched, dx0,
         torch.randint(0, DDPM_T, (16,), generator=gen, device="cuda"), torch.randn_like(dx0)))
    for sampled in (False, True):
        state = {"tokens": torch.randint(0, cfg.vocab, (4, 32), generator=gen, device="cuda",
                                         dtype=torch.int32),
                 "count": torch.tensor([32, 32, 1, 0], dtype=torch.int32, device="cuda"),
                 "pos": torch.tensor([0, 64, 120, 0], dtype=torch.int32, device="cuda"),
                 "cache": lm.init_paged_cache(cfg, 4 * 10, 16, dtype=torch.float32,
                                              device="cuda"),
                 "block_tables": torch.arange(4 * 10, dtype=torch.int32,
                                              device="cuda").reshape(4, 10)}
        if sampled:
            from repro_torch.serve.request import SamplingParams

            state.update(lm_steps.sampling_state(
                [SamplingParams(0.8, 50, 0.95, seed=3), None, SamplingParams(1.0, seed=4), None],
                "cuda"))
        cases[f"{LM_ARCH} depth {LM_ROUTE_DEPTH} slot step, "
              f"{'sampled' if sampled else 'greedy'} (captured)"] = (
            lambda p, st: lm_steps.make_slot_step(cfg)(p, st)[0], (lparams, state))
    for what, (fn, args) in cases.items():
        meta_args = dispatch_walk.meta_like(args)
        with dispatch_walk.Census(args=meta_args) as c:
            out = fn(*meta_args)
        counts = c.finish(out)
        _, syncs, launched = synced_step(fn, args, gm)
        census = counts.launches_by_name()
        if len(syncs) != len(counts.syncs) or launched != census:
            raise AssertionError(f"[audit] {what}: the card's {len(syncs)} sync warnings "
                                 f"{syncs[:3]} / launches {launched} vs the census's "
                                 f"{len(counts.syncs)} {[s.op for s in counts.syncs][:3]} / "
                                 f"{census}")
        steps_out[what] = dict(sync_warnings=len(syncs), census_syncs=len(counts.syncs),
                               launches=launched, census_flops=counts.flops,
                               census_kernel_tile_flops=counts.kernel_flops,
                               census_peak_bytes=counts.peak_bytes)
        print(f"[audit] {what} sparse step under set_sync_debug_mode('warn'): {len(syncs)} "
              f"sync warnings = the census's {len(counts.syncs)} host syncs on meta; launches "
              f"{launched} = the census's; census FLOPs {counts.flops} (torch ops) + "
              f"{counts.kernel_flops} (kernel tiles), eager peak {counts.peak_bytes} B "
              f"(meta, from shapes)", flush=True)
    del params, opt, lparams, lopt, mparams, dparams, cases
    gc.collect()
    torch.cuda.empty_cache()
    summary["steps"] = steps_out

    # the kernel route's tile FLOPs against the TPU-tiled FLOPs model
    ddpm_pol = dataclasses.replace(rpol, block_size=DDPM_BS)
    audits = {RESNET: savings.audit_resnet(RESNET, TRAIN_IMAGE, rpol, batch=TRAIN_BATCH),
              "ddpm": savings.audit_ddpm(DDPM_IMAGE, ddpm_pol, batch=DDPM_BATCH, base=DDPM_BASE),
              LM_ARCH: savings.audit_lm(get_config(LM_ARCH), lm_policy(policy_mod),
                                        batch=LM_BATCH, seq=LM_SEQ)}
    summary["tile_flops"] = {}
    for what, rep in audits.items():
        if rep.errors():
            raise AssertionError(f"[audit] savings {what}: "
                                 + "; ".join(f.message for f in rep.errors()))
        rows = [f for f in rep.findings if "ratio" in f.data]  # the kernel-route sites
        layers = {f.site: f.data["count"] for f in rep.findings if "count" in f.data}

        def total(get):
            return sum(get(f.data) * layers.get(f.site, 1) for f in rows)

        tiles = total(lambda d: d["tile_flops"])
        table = total(lambda d: d["table"][1])
        products = total(lambda d: d["product_flops"])
        summary["tile_flops"][what] = dict(sites=len(rows), tile_flops=tiles,
                                           tpu_table_flops=table, product_flops=products,
                                           ratio=tiles / table if table else 0.0)
        print(f"[audit] {what} kernel route, backward of every site (one sparse step): kernel "
              f"tile FLOPs {tiles} vs core/flops.py's TPU-tiled {table} "
              f"({tiles / table if table else 0:.4f}); products asked for {products}, equal "
              "to the model's unpadded count at every site", flush=True)
    summary["seconds"] = time.perf_counter() - t0
    print(f"[audit] {time.perf_counter() - t0:.1f} s", flush=True)
    return summary


def dryrun_mesh_seq_families(dryrun, tmesh, mf_seq_runs, get_config, pol):
    """``[mesh-seq]``'s whisper and paligemma runs (fp32, full width, B=1
    S=128 on 2x1) on the fake group: rank 0's sequence collectives a step,
    the cross K/V gradient sums apart, equal to what rank 0 counted on the
    card (``mf_seq_runs``, :func:`mesh_seq_report`'s rows). Returns the
    rows."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist import parallel

    summary = {}
    for arch in (ENCDEC_ARCH, VLM_ARCH):
        cut, fb, fs = MF_SEQ[arch]
        fcfg = dataclasses.replace(get_config(arch), dtype="float32", **cut)
        cell = dryrun.make_cell(fcfg, ShapeConfig("mesh-seq", fs, fb, "train"), pol,
                                {"data": 2, "model": 1})
        cell.meta["accum"] = 1
        parallel.counters.update(seq_calls=0, seq_bytes=0, kv_sum_calls=0, kv_sum_bytes=0)
        dryrun.step_census(cell, tmesh.make_fake_mesh(2, 1, rank=0))
        c, r = parallel.counters, mf_seq_runs[arch]
        have = (c["seq_calls"], c["seq_bytes"] / 1e6, c["kv_sum_calls"], c["kv_sum_bytes"] / 1e6)
        want = (r["seq_calls_per_step"], r["seq_mb_per_step"], r["kv_sum_calls_per_step"],
                r["kv_sum_mb_per_step"])
        if have != want:
            raise AssertionError(f"[dryrun] [mesh-seq] {arch} 2x1 rank 0: the sequence split's "
                                 f"(calls, MB, cross K/V sums, MB) a step {have} on the fake "
                                 f"group != {want} on the card")
        summary[f"mesh-seq {arch} 2x1 rank 0"] = dict(seq_calls=have[0], seq_mb=have[1],
                                                      kv_sum_calls=have[2], kv_sum_mb=have[3])
        print(f"[dryrun] [mesh-seq] {arch} 2x1 rank 0 on the fake group: the sequence split's "
              f"collectives a step {have[0]} calls, {have[1]:.4f} MB, of them the cross K/V "
              f"gradient sums {have[2]} calls, {have[3]:.4f} MB = the card's", flush=True)
    return summary


def dryrun_phase(mesh_train_summary, lock_steps, mf_seq_runs, get_config, policy_mod, card):
    """``[dryrun]`` (module docstring, 23c); ``lock_steps``:
    ``[mesh-data-serve]``'s counted lock-step decode step, every rank's, by
    layout; ``mf_seq_runs``: ``[mesh-families]``' ``[mesh-seq]`` rows.
    Returns its summary."""
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as tmesh

    t0 = time.perf_counter()
    pol = lm_policy(policy_mod)
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=MESH_DEPTH, dtype="bfloat16")
    shape = ShapeConfig("mesh-train", LM_SEQ, LM_BATCH, "train")
    real = {r["rank"]: r for r in mesh_train_summary["1x2_bf16"]}
    summary = {}
    try:
        for data, model in MESH_SHAPES:
            layout = f"{data}x{model}"
            ms = {"data": data, "model": model}
            cell = dryrun.make_cell(cfg, shape, pol, ms)
            cell.meta["accum"] = 1
            rb = dryrun.rank_bytes(cell, ms)
            per_step = [n // 2 for n in mesh_train_summary[layout]["matmul_by_rank"]]
            for rank in range(data * model):
                rec = dryrun.census_record(dryrun.step_census(
                    cell, tmesh.make_fake_mesh(data, model, rank=rank)))
                got = rec["launches"].get("matmul", 0)
                if got != per_step[rank]:
                    raise AssertionError(f"[dryrun] {layout} rank {rank}: census matmul {got} "
                                         f"!= {per_step[rank]} a sparse step on the card")
                row = dict(matmul=got, param_bytes=rb["params"], adam_bytes=rb["adam"],
                           calls=rec["collective_calls"], bytes=rec["collective_bytes"],
                           by_kind=rec["collectives"], host_syncs=rec["host_syncs"])
                if layout == "1x2":
                    r = real[rank]
                    want = (r["param_bytes"], r["adam_bytes"], r["coll_calls"], r["coll_bytes"])
                    have = (rb["params"], rb["adam"], rec["collective_calls"],
                            rec["collective_bytes"])
                    if have != want:
                        raise AssertionError(f"[dryrun] 1x2 rank {rank}: (params, Adam, calls, "
                                             f"bytes) {have} on the fake group != {want} on the "
                                             "card")
                summary[f"{layout} rank {rank}"] = row
                print(f"[dryrun] [mesh-train] {layout} rank {rank} on the fake group: "
                      f"{json.dumps(row)} = the card's ranks'", flush=True)
        # [mesh-data-serve]'s lock-step decode step: the serving config at
        # the CLI's slots and tokens, one step from position 0
        scfg = dataclasses.replace(get_config(LM_ARCH), n_layers=MESH_LOCK_DEPTH,
                                   dtype="float32")
        sshape = ShapeConfig("mesh-decode", lock_steps["max_seq"], lock_steps["batch"], "decode")
        for layout, every in lock_steps["ranks"].items():
            data, model = (int(n) for n in layout.split("x"))
            ms = {"data": data, "model": model}
            cell = dryrun.make_cell(scfg, sshape, pol, ms)
            rb = dryrun.rank_bytes(cell, ms)
            for real in every:
                rec = dryrun.census_record(dryrun.step_census(
                    cell, tmesh.make_fake_mesh(data, model, rank=real["rank"])))
                have = (rb["params"], rb["cache"], rec["collective_calls"],
                        rec["collective_bytes"])
                want = (real["param_bytes"], real["cache_bytes"], real["calls"], real["bytes"])
                if have != want:
                    raise AssertionError(f"[dryrun] lock-step decode {layout} rank "
                                         f"{real['rank']}: (params, cache, calls, bytes) {have} "
                                         f"on the fake group != {want} on the card")
                row = dict(param_bytes=rb["params"], cache_bytes=rb["cache"],
                           calls=rec["collective_calls"], bytes=rec["collective_bytes"],
                           by_kind=rec["collectives"], peak_bytes=rec["peak_bytes"])
                summary[f"lock-step decode {layout} rank {real['rank']}"] = row
                print(f"[dryrun] [mesh-data-serve] lock-step decode step {layout} rank "
                      f"{real['rank']} on the fake group: {json.dumps(row)} = the card's "
                      "ranks'", flush=True)
        # [mesh-seq]'s qwen2.5-3b run (fp32, depth 2, B=3 S=128 on 2x1): the
        # sequence split's collectives a step on the fake group, each rank's
        from repro_torch.dist import parallel

        t_seq = time.perf_counter()
        seq_cfg = dataclasses.replace(cfg, n_layers=MESH_SEQ_DEPTH, dtype="float32")
        seq_b, seq_s = MESH_SEQ_LM
        seq_real = mesh_train_summary["seq"]["runs"][LM_ARCH]
        cell = dryrun.make_cell(seq_cfg, ShapeConfig("mesh-seq", seq_s, seq_b, "train"), pol,
                                {"data": 2, "model": 1})
        cell.meta["accum"] = 1
        for rank in range(2):
            parallel.counters.update(seq_calls=0, seq_bytes=0)
            dryrun.step_census(cell, tmesh.make_fake_mesh(2, 1, rank=rank))
            have = (parallel.counters["seq_calls"], parallel.counters["seq_bytes"] / 1e6)
            want = (seq_real["seq_calls_per_step"], seq_real["seq_mb_per_step"])
            if rank == 0 and have != want:  # the card's numbers are rank 0's
                raise AssertionError(f"[dryrun] [mesh-seq] 2x1 rank 0: the sequence split's "
                                     f"(calls, MB) a step {have} on the fake group != {want} "
                                     "on the card")
            summary[f"mesh-seq 2x1 rank {rank}"] = dict(seq_calls=have[0], seq_mb=have[1])
            print(f"[dryrun] [mesh-seq] {LM_ARCH} 2x1 rank {rank} on the fake group: the "
                  f"sequence split's collectives a step {have[0]} calls, {have[1]:.4f} MB"
                  + (" = the card's" if rank == 0 else ""), flush=True)
        summary.update(dryrun_mesh_seq_families(dryrun, tmesh, mf_seq_runs, get_config, pol))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        tmesh._fake.clear()
    # train_tight (batch 8 of 4096 tokens) at full width and depth, rank 0 of
    # 16x16 and 2x16x16: data on the sequence (and pod on the batch)
    from repro_torch.dist import parallel

    for multi in (False, True):
        ms = tmesh.production_mesh_shape(multi_pod=multi)
        cell, _ = dryrun.build_cell(LM_ARCH, "train_tight", ms, "ssprop")
        blk = cell.meta["batch_block"]
        want_rows = 4 if multi else 8
        if (blk["rows"], blk["seq"]) != ([0, want_rows], [0, 256]):
            raise AssertionError(f"[dryrun] train_tight block {blk}")
        try:
            parallel.counters.update(seq_calls=0, seq_bytes=0)
            rec = dryrun.census_record(dryrun.step_census(
                cell, tmesh.make_production_mesh(multi_pod=multi)))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            tmesh._fake.clear()
        name = "2x16x16" if multi else "16x16"
        row = dict(block=[want_rows, 256], batch_axes=blk["batch_axes"],
                   seq_axes=blk["seq_axes"], peak_bytes=rec["peak_bytes"],
                   arg_bytes=rec["arg_bytes"], flops=rec["flops"],
                   collective_calls=rec["collective_calls"],
                   collective_bytes=rec["collective_bytes"],
                   seq_calls=parallel.counters["seq_calls"],
                   seq_bytes=parallel.counters["seq_bytes"])
        summary[f"{name} train_tight"] = row
        print(f"[dryrun] {LM_ARCH} x train_tight on {name}, rank 0: block [{want_rows}, 256] "
              f"(batch axes {blk['batch_axes']}, sequence axes {blk['seq_axes']}); eager peak "
              f"{rec['peak_bytes'] / 2**30:.2f} GiB, {rec['collective_calls']} collectives "
              f"({rec['collective_bytes'] / 2**30:.3f} GiB) a step, of them the sequence "
              f"split's {row['seq_calls']} ({row['seq_bytes'] / 2**30:.3f} GiB)", flush=True)
    print(f"[time] [dryrun] [mesh-seq] census and train_tight {time.perf_counter() - t_seq:.1f} s",
          flush=True)
    total = torch.cuda.mem_get_info()[1]
    for name in ("train_4k", "decode_32k"):
        ms = tmesh.production_mesh_shape()
        cell, _ = dryrun.build_cell(LM_ARCH, name, ms, "ssprop")
        rb = dryrun.rank_bytes(cell, ms)
        status = dryrun.refusal(cell, ms, "ssprop") or "runs"
        row = dict(rank_bytes=rb, card_bytes=total, status=status)
        peak = ""
        if name == "decode_32k":  # the lock-step decode step, run on the fake group
            try:
                rec = dryrun.census_record(dryrun.step_census(cell, tmesh.make_production_mesh()))
            finally:
                if dist.is_initialized():
                    dist.destroy_process_group()
                tmesh._fake.clear()
            row.update(peak_bytes=rec["peak_bytes"], collective_calls=rec["collective_calls"],
                       flops=rec["flops"])
            peak = (f", its eager peak {rec['peak_bytes'] / 2**30:.3f} GiB, "
                    f"{rec['collective_calls']} collectives a step")
        summary[f"16x16 {name}"] = row
        print(f"[dryrun] {LM_ARCH} x {name} on 16x16, rank 0: argument bytes {json.dumps(rb)} "
              f"= {rb['total'] / 2**30:.3f} GiB of the card's {total / 2**30:.2f} GiB "
              f"({card}); the CLI: {status}{peak}", flush=True)
    summary.update(dryrun_heads_cells(dryrun, tmesh, dist, card))
    summary.update(dryrun_tight_cells(dryrun, tmesh, dist, card))
    summary["seconds"] = time.perf_counter() - t0
    print(f"[dryrun] {time.perf_counter() - t0:.1f} s", flush=True)
    return summary


# [dryrun]'s census of the cells a model mesh that cuts the q heads opens:
# arch -> its depth cut (full width; the CPU dry run steps them at full depth)
DRYRUN_HEADS = {ENCDEC_ARCH: dict(n_layers=1, n_enc_layers=1), VLM_ARCH: dict(n_layers=1),
                "llama4-maverick-400b-a17b": dict(n_layers=2)}  # one dense, one MoE layer
DRYRUN_HEADS_SHAPES = ("train_4k", "train_tight", "prefill_32k", "decode_32k")


def dryrun_heads_cells(dryrun, tmesh, dist, card):
    """Rank 0 of 16x16 under ``ssprop`` on the fake group, at full width
    and the depths of ``DRYRUN_HEADS``: the census of whisper's,
    paligemma's and llama4's ``train_4k``, ``prefill_32k`` and
    ``decode_32k`` and llama4's ``train_tight`` (each rank runs its q head
    span), their argument bytes (a decode cell's state as the port holds
    it beside the reference's spec's), peak and collectives; none is
    refused (whisper's and paligemma's ``train_tight``:
    :func:`dryrun_tight_cells`). Returns the rows."""
    from repro_torch.configs.base import SHAPES

    t0 = time.perf_counter()
    ms = tmesh.production_mesh_shape()
    out = {}
    try:
        for arch, cut in DRYRUN_HEADS.items():
            cfg, table = dryrun.resolve(arch, "ssprop", ms)
            cfg = dataclasses.replace(cfg, **cut)
            for name in DRYRUN_HEADS_SHAPES:
                if name == "train_tight" and cfg.family in ("encdec", "vlm"):
                    continue  # [dryrun] [tight]
                cell = dryrun.make_cell(cfg, SHAPES[name], table, ms)
                why = dryrun.refusal(cell, ms, "ssprop")
                if why:
                    raise AssertionError(f"[dryrun] {arch} x {name}: refusal {why!r}")
                rb = dryrun.rank_bytes(cell, ms)
                rec = dryrun.census_record(dryrun.step_census(cell, tmesh.make_production_mesh()))
                row = dict(status="ok", depth=cfg.n_layers, rank_bytes=rb,
                           peak_bytes=rec["peak_bytes"], flops=rec["flops"],
                           collectives=rec["collectives"],
                           collective_calls=rec["collective_calls"],
                           collective_bytes=rec["collective_bytes"], launches=rec["launches"])
                if "cache_kv_heads" in cell.meta:
                    row["kv_heads"] = cell.meta["cache_kv_heads"]
                out[f"{arch} {name}"] = row
                print(f"[dryrun] [heads] {arch} x {name} on 16x16, rank 0, depth "
                      f"{cfg.n_layers} of full width: argument bytes {json.dumps(rb)}; eager peak "
                      f"{rec['peak_bytes'] / 2**30:.3f} GiB; {rec['collective_calls']} collectives "
                      f"({rec['collective_bytes'] / 2**30:.3f} GiB) a step: "
                      f"{json.dumps(rec['collectives'])} ({card})", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        tmesh._fake.clear()
    print(f"[time] [dryrun] [heads] {len(out)} cells {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def dryrun_tight_cells(dryrun, tmesh, dist, card):
    """``[dryrun] [tight]``: whisper's and paligemma's ``train_tight``
    (batch 8 of 4096 tokens: ``data`` on the sequence, 256 a rank) on
    16x16 under ``ssprop``, rank 0 on the fake group, at full width and
    the depths of ``DRYRUN_HEADS``: the batch block (whisper's frames
    whole past their rows, paligemma's 16 patches beside its tokens),
    argument bytes, eager peak, the collectives a step and their GiB, of
    them the sequence split's and the cross-attention K/V gradient sums'
    (whisper's; none for paligemma). Returns the rows."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.dist import parallel

    t0 = time.perf_counter()
    ms = tmesh.production_mesh_shape()
    out = {}
    try:
        for arch in (ENCDEC_ARCH, VLM_ARCH):
            cfg, table = dryrun.resolve(arch, "ssprop", ms)
            cfg = dataclasses.replace(cfg, **DRYRUN_HEADS[arch])
            cell = dryrun.make_cell(cfg, SHAPES["train_tight"], table, ms)
            why, blk = dryrun.refusal(cell, ms, "ssprop"), cell.meta.get("batch_block")
            encdec = cfg.family == "encdec"
            if why or blk is None or blk["seq"] != [0, 256] or (
                    "whole" in blk) != encdec or ("patches" in blk) == encdec:
                raise AssertionError(f"[dryrun] [tight] {arch}: refusal {why!r}, block {blk}")
            rb = dryrun.rank_bytes(cell, ms)
            parallel.counters.update(calls=0, bytes=0, seq_calls=0, seq_bytes=0, kv_sum_calls=0,
                                     kv_sum_bytes=0)
            rec = dryrun.census_record(dryrun.step_census(cell, tmesh.make_production_mesh()))
            c = dict(parallel.counters)
            if (not c["seq_calls"] or bool(c["kv_sum_calls"]) != encdec
                    or (c["calls"], c["bytes"]) != (rec["collective_calls"],
                                                    rec["collective_bytes"])):
                raise AssertionError(f"[dryrun] [tight] {arch}: counters {c} vs the census's "
                                     f"{rec['collective_calls']} calls")
            row = dict(depth=[cfg.n_layers] + ([cfg.n_enc_layers] if encdec else []),
                       block={k: v for k, v in blk.items() if k != "whole"},
                       whole=[w.split(":")[0] for w in blk.get("whole", ())], rank_bytes=rb,
                       peak_bytes=rec["peak_bytes"], flops=rec["flops"],
                       collective_calls=rec["collective_calls"],
                       collective_bytes=rec["collective_bytes"], seq_calls=c["seq_calls"],
                       seq_bytes=c["seq_bytes"], kv_sum_calls=c["kv_sum_calls"],
                       kv_sum_bytes=c["kv_sum_bytes"],
                       kv_sum_share=c["kv_sum_bytes"] / rec["collective_bytes"])
            out[f"{arch} train_tight"] = row
            print(f"[dryrun] [tight] {arch} x train_tight on 16x16, rank 0, depth "
                  f"{' + '.join(map(str, row['depth']))} of full width: block {json.dumps(blk)}; "
                  f"argument bytes {json.dumps(rb)}; eager peak {rec['peak_bytes'] / 2**30:.3f} "
                  f"GiB; {rec['collective_calls']} collectives "
                  f"({rec['collective_bytes'] / 2**30:.4f} GiB) a step, of them the sequence "
                  f"split's {c['seq_calls']} ({c['seq_bytes'] / 2**30:.4f} GiB) and the cross "
                  f"K/V gradient sums {c['kv_sum_calls']} ({c['kv_sum_bytes'] / 2**30:.4f} GiB, "
                  f"{row['kv_sum_share']:.4f} of the bytes) ({card})", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        tmesh._fake.clear()
    print(f"[time] [dryrun] [tight] {len(out)} cells {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from repro_torch.configs.registry import get_config
    from repro_torch.core import backward
    from repro_torch.core import conv
    from repro_torch.core import flops
    from repro_torch.core import policy as policy_mod
    from repro_torch.core import sparsity
    from repro_torch.data import pipeline
    from repro_torch.kernels import build
    from repro_torch.kernels import gathered_matmul as gm
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch import serve as serve_pkg
    from repro_torch.checkpoint import ckpt as ckpt_lib
    from repro_torch.launch import serve
    from repro_torch.launch import steps as lm_steps
    from repro_torch.launch import train
    from repro_torch.launch import train_classifier as tc
    from repro_torch.launch import train_ddpm as td
    from repro_torch.models import ddpm
    from repro_torch.models import model as lm
    from repro_torch.models import resnet
    from repro_torch.optim import adam
    from repro_torch.optim import compression

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
    # every launch from here on is recorded for [audit]
    launch_log = LaunchLog()
    observing = gm.observe_launches(launch=launch_log.add)
    observing.__enter__()
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
    serve_profile = step_profile(cfg, lm, params, captured=True)
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
    out, seen = on_device(lambda: serve.run(args))
    wall = time.perf_counter() - t0
    launches = pa.launches
    if seen["paged_attention"] != launches:
        raise AssertionError(f"[serve] paged_attention ran {seen['paged_attention']} times on "
                             f"the device, the counter says {launches}")
    serve_device = seen["paged_attention"]
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
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
          f"paged_attention launches {launches} = {cfg.n_layers} x {steps}, the device ran as "
          f"many (the run under its tracing)")
    print("[serve] first request tokens:", gen[0][:16].tolist())
    serve_argv = list(argv)
    serve_captured = serve_captured_vs_eager(serve, cfg, params, argv, out, pa)
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
    # 7. training-route check at full width; then the same step under a
    # TP-sharded selection, and grouped convs, on the kernels
    train_rel, resnet_state = training_route_check(tc, resnet, backward, policy_mod, pipeline)
    t_shard = time.perf_counter()
    shard_rel, shard_launches = shard_route_phase(tc, resnet, backward, sparsity, policy_mod, gm,
                                                  *resnet_state)
    del resnet_state
    torch.cuda.empty_cache()
    grouped_launches, grouped_rows, grouped_err = grouped_phase(gm, ops, conv, backward,
                                                                policy_mod)
    new_phase_s = {"shard-route+grouped": time.perf_counter() - t_shard}
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
    lm_rel, lm_state = lm_route_check(lm, lm_steps, backward, policy_mod, pipeline, cfg)
    t_tp = time.perf_counter()
    tp_rel = tp_lm_route_check(lm, lm_steps, backward, policy_mod, gm, *lm_state)
    new_phase_s["tp-lm route"] = time.perf_counter() - t_tp
    del lm_state
    gc.collect()
    torch.cuda.empty_cache()
    lm_launches, lm_ms = lm_training_phase(train, lm, gm, pa, policy_mod, cfg)
    _, lm_state = lm_profile(lm, lm_steps, adam, policy_mod, pipeline, cfg)
    t_tp = time.perf_counter()
    tp_summary = tp_lm_phase(lm, lm_steps, adam, compression, flops, sparsity, policy_mod, gm,
                             cfg, lm_state, lm_ms)
    new_phase_s["tp-lm steps"] = time.perf_counter() - t_tp
    gc.collect()
    torch.cuda.empty_cache()

    lap("lm-train")
    # 15b. fault-tolerant LM training: save, crash, resume and replay through
    # the entry point (counted), then a 2-rank fleet's sharded checkpoint
    gc.collect()
    torch.cuda.empty_cache()
    resume_launches, ckpt_summary = ckpt_phase(train, lm, gm, adam, policy_mod, ckpt_lib)
    gc.collect()
    torch.cuda.empty_cache()
    fleet_summary = fleet_phase(gm, lm, policy_mod, get_config)

    lap("ckpt-fleet")
    # 15c. device meshes: qwen2.5-3b trains on 1x2 and 2x1 and serves on a
    # model mesh of 2, a rank a process, against the 1x1 runs
    gc.collect()
    torch.cuda.empty_cache()
    t_mesh = time.perf_counter()
    (mesh_train_launches, mesh_serve_launches, mesh_err, mesh_train_summary,
     mesh_serve_summary) = mesh_phase(train, serve, lm, gm, policy_mod, get_config, serve_argv,
                                      card)
    mesh_data_launches = mesh_serve_summary["data"]["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[time] mesh phases {time.perf_counter() - t_mesh:.1f} s together")

    lap("mesh")
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
    moe_launches, moe_summary, kimi_one = moe_serve_phase(lm, pa, serve_pkg, get_config, serve)
    fam_rel = families_reduced_phase(lm, lm_steps, backward, policy_mod, pipeline, gm, pa,
                                     serve_pkg, get_config)
    t_moe = time.perf_counter()
    moe_rel, moe_grouped_launches = moe_grouped_phase(lm, lm_steps, backward, policy_mod,
                                                      pipeline, gm, get_config)
    new_phase_s["moe-grouped"] = time.perf_counter() - t_moe
    print(f"[time] sharded-selection phases {json.dumps(new_phase_s)}: "
          f"{sum(new_phase_s.values()):.1f} s together")

    lap("families")
    # 20-22. the encoder-decoder and VLM families at full width: serving at
    # depth 2 (paged_attention at head dims 64 and 256), then training at
    # full depth
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
    # 23. the other families on device meshes: training at 1x2 and 2x1,
    # serving on a model mesh of 2, against the 1x1 runs
    gc.collect()
    torch.cuda.empty_cache()
    mf_mm_launches, mf_pa_launches, mf_err, mf_summary = mesh_families_phase(
        train, serve, lm, gm, pa, get_config, kimi_one, card)
    del kimi_one

    lap("mesh-families")
    # 23a. model meshes that do not divide the q heads: whisper at full
    # width on 8 ranks, the llama4-like and paligemma-like reduced configs
    # on 4, each rank running the heads its q columns touch
    gc.collect()
    torch.cuda.empty_cache()
    mh_mm_launches, mh_pa_launches, mh_err, mh_summary = mesh_heads_phase(
        train, serve, lm, gm, pa, get_config, card)

    lap("mesh-heads")
    # 15b, then 23b-c: a fleet on meshes (its launchers, processes of their
    # own, run while this process audits), the program auditor and the dry
    # run, held to the card
    gc.collect()
    torch.cuda.empty_cache()
    finish_fleet_mesh = fleet_mesh_phase(train, lm, gm, policy_mod, get_config, card)
    observing.__exit__(None, None, None)
    audit_summary = audit_phase(launch_log, gm, get_config, lm, lm_steps, tc, resnet, adam,
                                policy_mod, card)
    dryrun_summary = dryrun_phase(mesh_train_summary, mesh_serve_summary["data"]["step"],
                                  mf_summary["seq"]["runs"], get_config, policy_mod, card)
    fleet_mesh_summary = finish_fleet_mesh()

    lap("fleet-mesh-audit-dryrun")
    # 24. result lines
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
        launches=(launches + feat_launches + moe_launches + enc_launches + vlm_launches
                  + mesh_serve_launches + mesh_data_launches + mf_pa_launches + mh_pa_launches),
        launches_by_path={"serve": launches, "serve_features": feat_launches,
                          "moe_serve": moe_launches, "encdec_serve": enc_launches,
                          "vlm_serve": vlm_launches, "mesh_serve": mesh_serve_launches,
                          "mesh_data_serve": mesh_data_launches,
                          "mesh_families": mf_pa_launches, "mesh_heads": mh_pa_launches},
        # the captured path's launches as the device ran them (on_device)
        device_launches={"serve": serve_device},
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
        by_path = {RESNET: train_launches[name], "ddpm": ddpm_launches[name],
                   f"{RESNET}_tp{SHARD_TP}": shard_launches[name],
                   "grouped": grouped_launches[name]}
        g_top = [r for r in grouped_rows if r["name"] == name][:1]  # G=2, 256 channels
        kernels.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/{name}.cu",
            replaces=replaces, launches=sum(by_path.values()), launches_by_path=by_path,
            device_launches={RESNET: train_ms["device_launches"][name],
                             "ddpm": ddpm_ms["device_launches"][name]},
            max_abs_err=max(g_err[name], d_err[name], grouped_err[name]),
            ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
            bound_by=top["bound_by"], library_ms=top["library_ms"], shape=top["shape"],
            # one sparse step's launches of this kernel, at their shapes
            step_ms=sum(r["ms"] * r["launches_per_step"] for r in mine),
            variant=top["variant"], tflops=top["tflops"],
            ddpm={k: d_top[k] for k in ("shape", "ms", "plain_ms", "library_ms", "bound_ms",
                                        "bound_by", "tflops")}
            | {"step_ms": sum(r["ms"] * r["launches_per_step"] for r in d_mine)},
            **({"grouped": {k: g_top[0][k] for k in ("shape", "ms", "plain_ms", "library_ms",
                                                     "bound_ms", "bound_by", "tflops")}}
               if g_top else {}),
        ))
    for name, replaces in LM_KERNELS.items():
        mine = [r for r in lm_rows if r["name"] == name and r["dtype"] == "bfloat16"]
        top = max(mine, key=lambda r: (r["flops"], r["ms"]))  # the main path's largest shape
        path_launches, err, by_arch = {LM_ARCH: lm_launches[name]}, lm_err[name], {}
        if name == "matmul":
            path_launches["lm_resume"] = resume_launches
            path_launches["fleet_mesh"] = sum(sum(v) for v in
                                              fleet_mesh_summary["launches"].values())
            path_launches["mesh_train"] = mesh_train_launches
            path_launches["mesh_families"] = mf_mm_launches
            path_launches["mesh_heads"] = mh_mm_launches
            # [mesh-seq]: the seq-split runs' 1x1 references and every rank's
            path_launches["mesh_seq"] = (mesh_train_summary["seq"]["launches"]
                                         + mf_summary["seq"]["launches"])
            path_launches["moe_grouped"] = sum(moe_grouped_launches.values())
            path_launches[SSM_ARCH] = ssm_launches
            path_launches.update({arch: xtrain[arch][0] for arch in xtrain})
            # whisper's and paligemma's sparse steps, and the fleet's reduced
            # qwen2.5-3b (B=8, S=64): the worst error, and one step's
            # launches at their shapes (bf16)
            more = x_rows | {f"{LM_ARCH} reduced (fleet)": (fleet_summary["kernel_rows"],
                                                            fleet_summary["kernel_err"])}
            err = max([err, mesh_err, mf_err, mh_err, mesh_train_summary["seq"]["max_abs_err"],
                       max(fleet_mesh_summary["matmul_err"].values()),
                       mf_summary["seq"]["max_abs_err"]] + [e[name] for _, e in more.values()])
            by_arch = {arch: dict(max_abs_err=e[name], step_ms=sum(
                r["ms"] * r["launches_per_step"] for r in xr if r["dtype"] == "bfloat16"))
                for arch, (xr, e) in more.items()}
            # every product of the mesh ranks' sparse steps, on its own operands
            by_arch["mesh_train"] = dict(max_abs_err=mesh_err, products=sum(
                c[0] for r in mesh_train_summary["matmul_checks"].values()
                for k, c in r.items() if not k.startswith("seq ")))
            by_arch["mesh_families"] = dict(max_abs_err=mf_err)
            by_arch["mesh_heads"] = dict(max_abs_err=mh_err)
            by_arch["fleet_mesh"] = dict(max_abs_err=max(fleet_mesh_summary["matmul_err"].values()))
            by_arch["mesh_seq"] = dict(max_abs_err=max(
                mesh_train_summary["seq"]["max_abs_err"], mf_summary["seq"]["max_abs_err"]))
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
    print(f"[serve] captured against eager {json.dumps(serve_captured)}; decode and mixed step "
          f"profiles {json.dumps(serve_profile)}")
    print(f"[train] training-route rel L2 {train_rel}; step medians {train_ms}")
    print(f"[ddpm-train] route rel L2 {ddpm_rel}; step medians {ddpm_ms}")
    print(f"[lm-train] route rel L2 {lm_rel}; step medians {lm_ms}")
    print(f"[ckpt] {json.dumps(ckpt_summary)}")
    print(f"[fleet] {json.dumps({k: v for k, v in fleet_summary.items() if k != 'kernel_rows'})}")
    print(f"[fleet-mesh] {json.dumps(fleet_mesh_summary)}")
    print(f"[ssm-train] {json.dumps(ssm_ms)}")
    print(f"[ssm-serve] shares {json.dumps(ssm_shares)}")
    print(f"[moe-serve] {json.dumps(moe_summary)}")
    print(f"[family-route] worst relative L2 {json.dumps(fam_rel)}")
    print(f"[shard-route] worst relative L2 {json.dumps(shard_rel)}; launches "
          f"{json.dumps(shard_launches)}")
    print(f"[grouped] launches {json.dumps(grouped_launches)}; max abs err "
          f"{json.dumps(grouped_err)}")
    print(f"[tp-lm] route worst relative L2 {json.dumps(tp_rel)}; {json.dumps(tp_summary)}")
    print(f"[moe-grouped] worst relative L2 {json.dumps(moe_rel)}; matmul launches "
          f"{json.dumps(moe_grouped_launches)}")
    print(f"[serve-features] {json.dumps(feat_summary)}")
    print(f"[encdec-serve] {json.dumps(enc_summary)}")
    print(f"[vlm-serve] {json.dumps(vlm_summary)}")
    print(f"[xfamily-train] {json.dumps({a: v[1] for a, v in xtrain.items()})}")
    print(f"[mesh-train] {json.dumps(mesh_train_summary)}")
    print(f"[mesh-serve] {json.dumps(mesh_serve_summary)}")
    print(f"[mesh-families] {json.dumps(mf_summary)}")
    print(f"[mesh-heads] {json.dumps(mh_summary)}")
    print(f"[audit] {json.dumps(audit_summary)}")
    print(f"[dryrun] {json.dumps(dryrun_summary)}")
    print(f"[device] {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
