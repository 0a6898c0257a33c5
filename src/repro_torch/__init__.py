"""PyTorch + CUDA port of ``repro`` for an NVIDIA H100.

Mirrors the JAX package's layout (``configs/``, ``kernels/``,
``models/``, ``launch/``, ``serve/``) so every module has an obvious
twin, and imports nothing of it. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``. Ported so far: serving the dense family
(qwen2.5-3b) through the paged continuous-batching engine, with
``paged_attention`` as a hand-written CUDA kernel
(``kernels/csrc/paged_attention.cu``).
"""
