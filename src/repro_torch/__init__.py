"""PyTorch + CUDA port of ``repro`` for an NVIDIA H100.

Mirrors the JAX package's layout (``configs/``, ``core/``, ``data/``,
``kernels/``, ``models/``, ``optim/``, ``launch/``, ``serve/``) so every
module has an obvious twin, and imports nothing of it. Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``. Ported so far:
serving the dense family (qwen2.5-3b) with everything the JAX engine
does (the paged and contiguous caches, sampling drawn as ``jax.random``
draws, swap preemption, speculative decoding, the lock-step oracle),
with ``paged_attention`` as a hand-written CUDA kernel; ssProp training
of the ResNets through the channel-sparse backward engine, with the four gathered backward kernels
(``dx_gathered``, ``dw_gathered``, ``conv_dw_fused``, ``conv_dx_fused``);
ssProp training of the paper's DDPM UNet through the same kernels, with
the paper's backward-FLOPs ledger and task configs; and ssProp training
of the dense LM at channel granularity, with the
shrunk products in the ``matmul`` kernel; then every model family of the
registry, fault-tolerant training, sharded selection, and device meshes
on which every family trains (``data x model``) and serves (``model``),
a rank a process (``launch/mesh.py``). Every kernel is hand-written
CUDA (``kernels/csrc/``), ``importance`` included.
"""
