"""Full fp32 for the training CLIs: TF32 off for matmuls and convolutions.

PyTorch leaves ``torch.backends.cudnn.allow_tf32`` True by default, so
an fp32 convolution on the card would run in TF32 (about three decimal
digits) while the JAX package, which the port is held to, computes it
in fp32. :func:`fp32_precision` turns both TF32 switches off for the
duration of a run and restores them on exit.
"""
from __future__ import annotations

import contextlib

import torch


def tf32_flags() -> dict[str, bool]:
    """The two TF32 switches as they stand."""
    return {
        "matmul": bool(torch.backends.cuda.matmul.allow_tf32),
        "cudnn": bool(torch.backends.cudnn.allow_tf32),
    }


@contextlib.contextmanager
def fp32_precision():
    """TF32 off for float32 matmuls and convolutions inside the block;
    yields the flags in force there and restores the caller's on exit."""
    before = tf32_flags()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield tf32_flags()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before["matmul"]
        torch.backends.cudnn.allow_tf32 = before["cudnn"]
