"""Deterministic synthetic image data.

The port's copy of ``repro.data.pipeline``'s image half, in numpy, so
that both packages see the same batches (``tests/test_torch_train.py``
holds the arrays equal). Labels are a function of the input
(class-conditional Gaussian blobs plus noise), so training loss falls
and dense-vs-ssProp comparisons mean something; ``batch_at(step)`` is a
pure function of (seed, step).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ImagePipelineConfig:
    image: tuple[int, int, int]  # (C, H, W)
    n_classes: int
    global_batch: int
    seed: int = 0


class ImagePipeline:
    """Synthetic classification set: class-conditional Gaussian blobs +
    noise, mimicking the paper's CIFAR/MNIST setups, over a fixed finite
    'train set'."""

    def __init__(self, cfg: ImagePipelineConfig, n_train: int = 4096):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        c, h, w = cfg.image
        self._protos = rng.normal(0, 1, size=(cfg.n_classes, c, h, w)).astype(np.float32)
        self._labels = rng.integers(0, cfg.n_classes, size=n_train).astype(np.int32)
        self._noise_seed = rng.integers(0, 2**31)
        self.n_train = n_train

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((self._noise_seed, step))
        idx = rng.integers(0, self.n_train, size=cfg.global_batch)
        y = self._labels[idx]
        # fixed per-example noise (so the set is finite & memorizable)
        ex_rng = np.random.default_rng(42)
        noise_bank = ex_rng.normal(0, 0.5, size=(256,) + cfg.image).astype(np.float32)
        x = self._protos[y] + noise_bank[idx % 256]
        return {"images": x, "labels": y}

    def eval_batch(self, n: int = 256) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(999)
        y = rng.integers(0, cfg.n_classes, size=n).astype(np.int32)
        x = self._protos[y] + rng.normal(0, 0.5, size=(n,) + cfg.image).astype(np.float32)
        return {"images": x.astype(np.float32), "labels": y}
