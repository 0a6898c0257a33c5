"""Deterministic synthetic data: token streams and images.

The port's copy of ``repro.data.pipeline``, in numpy, so that both
packages see the same batches (``tests/test_torch_train.py`` and
``tests/test_torch_lm_train.py`` hold the arrays equal). The data has
learnable structure (an order-2 Markov token stream; class-conditional
Gaussian blobs plus noise), so training loss falls and dense-vs-ssProp
comparisons mean something; ``batch_at(step)`` is a pure function of
(seed, step).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_classes: int = 0  # unused for LM


class TokenPipeline:
    """Synthetic LM corpus: an order-2 Markov stream with a fixed random
    transition structure (real next-token signal: loss can drop well
    below log(V))."""

    def __init__(self, cfg: TokenPipelineConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # sparse-ish transition: each (prev) maps to 8 likely tokens
        self._succ = rng.integers(0, cfg.vocab, size=(min(cfg.vocab, 4096), 8))

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """``{"tokens", "targets"}``, each int32 ``[global_batch, seq_len]``,
        targets the tokens shifted by one."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        toks = np.empty((cfg.global_batch, cfg.seq_len + 1), np.int32)
        cur = rng.integers(0, cfg.vocab, size=cfg.global_batch)
        toks[:, 0] = cur
        noise = rng.random((cfg.global_batch, cfg.seq_len))
        pick = rng.integers(0, 8, size=(cfg.global_batch, cfg.seq_len))
        for t in range(cfg.seq_len):
            nxt = self._succ[toks[:, t] % self._succ.shape[0], pick[:, t]]
            rand = rng.integers(0, cfg.vocab, size=cfg.global_batch)
            toks[:, t + 1] = np.where(noise[:, t] < 0.1, rand, nxt)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def frontend_inputs(cfg, global_batch: int, seed: int, step: int) -> dict[str, np.ndarray]:
    """The stubbed frontends' outputs a step's batch carries besides its
    tokens: ``frames [B, enc_seq, d_model]`` for the encoder-decoder
    family, ``patches [B, n_patches, d_model]`` for the VLM, fp32
    standard normal draws, a pure function of (seed, step); nothing for
    the other families. The reference's pipeline gives tokens alone."""
    rows = {"encdec": ("frames", cfg.enc_seq), "vlm": ("patches", cfg.n_patches)}
    if cfg.family not in rows:
        return {}
    name, n = rows[cfg.family]
    rng = np.random.default_rng((seed, step, 1))
    return {name: rng.standard_normal((global_batch, n, cfg.d_model)).astype(np.float32)}


def rank_block(batch: dict[str, np.ndarray], layout) -> dict[str, np.ndarray]:
    """A mesh rank's block of a global batch (``models/model.py::BatchLayout``):
    its rows of every input; of ``tokens``, ``targets`` and ``loss_mask``
    its block of the sequence; of the VLM's ``patches`` its patch block;
    the encoder-decoder's ``frames`` whole past their rows (the encoder
    runs alike on every rank of a sequence split)."""
    lo, hi = layout.rows

    def one(k, v):
        if k in ("tokens", "targets", "loss_mask"):
            return layout.block(v)
        return layout.patch_block(v) if k == "patches" else v[lo:hi]

    return {k: one(k, v) for k, v in batch.items()}


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


def input_specs(cfg, shape, *, device="meta") -> dict[str, torch.Tensor]:
    """Empty stand-ins on ``device`` (default ``meta``: nothing allocated)
    for every model input of one cell: ``cfg`` a ``ModelConfig``,
    ``shape`` a ``ShapeConfig``. Tokens (and targets, but for decode) are
    int32; a train or prefill batch of the encoder-decoder or the VLM
    adds ``frames [B, enc_seq, d]`` / ``patches [B, n_patches, d]`` in
    ``cfg.dtype``, as :func:`frontend_inputs` does."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        specs = {"tokens": torch.empty((b, 1), dtype=torch.int32, device=device)}
    else:
        specs = {"tokens": torch.empty((b, s), dtype=torch.int32, device=device),
                 "targets": torch.empty((b, s), dtype=torch.int32, device=device)}
    rows = {"encdec": ("frames", cfg.enc_seq), "vlm": ("patches", cfg.n_patches)}
    if cfg.family in rows and shape.kind != "decode":
        name, n = rows[cfg.family]
        specs[name] = torch.empty((b, n, cfg.d_model), dtype=getattr(torch, cfg.dtype),
                                  device=device)
    return specs
