"""The parts of ``jax.random`` the port draws from, bit for bit.

Not a twin of a module of ``repro``: the JAX package takes these from
JAX itself (``jax.random.fold_in`` and ``jax.random.categorical`` in
``repro.launch.steps.sample_tokens``; ``jax.random.permutation`` in
``repro.core.sparsity`` for random selection; ``jax.random.split`` and
``jax.random.bernoulli`` in ``repro.models.resnet``'s dropout). The port
reproduces them in torch integer arithmetic so that a sampled token
stream, a random channel selection or a dropout mask here is the JAX
package's own, not only one from the same distribution.

What is reproduced (jax 0.9.0, the default threefry PRNG with
``jax_threefry_partitionable = True``):

* :func:`threefry2x32` — Threefry-2x32, 20 rounds (5 groups of 4, with
  rotations 13, 15, 26, 6 / 17, 29, 16, 24), the key schedule
  ``(k0, k1, k0 ^ k1 ^ 0x1BD11BDA)`` injected after each group with the
  group number added to the second word;
* :func:`fold_in` — ``threefry2x32(key, (0, data))``: the new key is the
  two output words;
* :func:`random_bits` — 32-bit draws in the partitionable layout: the
  counter of element ``i`` is the pair (high word, low word) of ``i``,
  and the draw is ``x0 ^ x1`` of its hash;
* :func:`uniform` — ``(bits >> 9) | 0x3F800000`` read as a float32 in
  [1, 2), minus 1, scaled into ``[minval, maxval)`` and clamped below at
  ``minval``;
* :func:`gumbel` — ``-log(-log(uniform(tiny, 1)))`` (JAX's "low" mode);
* :func:`categorical` — ``argmax(logits + gumbel)`` along the last axis;
* :func:`split` — key ``i`` of ``num`` is ``threefry2x32(key, (0, i))``
  (the partitionable split, the same hash as ``fold_in(key, i)``);
* :func:`bernoulli` — ``uniform(key, shape) < p``, ``p`` a float32 (the
  "low" mode);
* :func:`permutation` — ``jax.random.permutation(key, n)``: ``ceil(3 ln n
  / ln(2^32 - 1))`` rounds (two past n = 1625), each splitting the key
  and stably sorting by 32-bit :func:`random_bits` of the subkey.

The samplers are vectorised over rows: ``keys [B, 2]`` (one raw key a
row, uint32 words held in int64), ``data [B]``, and ``n`` columns a row;
:func:`key`, :func:`split`, :func:`bernoulli` and :func:`permutation`
take one ``[2]`` key, as their JAX counterparts take one key.
Words are int64 tensors masked to 32 bits, which gives the same bits on
the CPU and on the card. The float steps (``log``) round as the device's
``log`` does, so a Gumbel draw may differ from JAX's in its last bit.
"""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY32 = float(np.finfo(np.float32).tiny)


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the counter words ``(x0, x1)`` under the key
    ``(k0, k1)``; all int64 tensors holding uint32 values, broadcast
    together. Returns the two hashed words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for group in range(5):
        for r in _ROTATIONS[group % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(group + 1) % 3]) & MASK32
        x1 = (x1 + ks[(group + 2) % 3] + group + 1) & MASK32
    return x0, x1


def key_words(keys: torch.Tensor) -> torch.Tensor:
    """Raw ``[..., 2]`` uint32 key data as int64 words."""
    return keys.to(torch.int64) & MASK32


def fold_in(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` row by row: ``keys [B, 2]``, ``data [B]``
    (non-negative ints) -> ``[B, 2]`` int64 keys."""
    keys = key_words(keys)
    data = data.to(device=keys.device, dtype=torch.int64) & MASK32
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` 32-bit draws a row (``jax.random.bits`` of shape ``(n,)``
    under each row's key): ``keys [B, 2]`` -> ``[B, n]`` int64."""
    keys = key_words(keys)
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(
        keys[:, 0:1], keys[:, 1:2], (idx >> 32)[None, :], (idx & MASK32)[None, :]
    )
    return y0 ^ y1


def uniform(keys: torch.Tensor, n: int, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)`` a row:
    ``[B, n]`` float32."""
    bits = random_bits(keys, n)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=f.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=f.device)
    # XLA fuses ``f * (hi - lo) + lo`` into one rounding: the product of
    # two float32s is exact in float64, so the float64 sum rounded once
    # to float32 gives the fused result
    scaled = (f.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` a row (mode "low")."""
    return -torch.log(-torch.log(uniform(keys, n, _TINY32, 1.0)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` a row: ``keys [B, 2]``,
    float32 ``logits [B, V]`` -> ``[B]`` int64 (the first index of the
    largest perturbed logit)."""
    g = gumbel(keys.to(logits.device), logits.shape[-1])
    return torch.argmax(g + logits, dim=-1)


def key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.key_data(jax.random.PRNGKey(seed))`` of a seed in
    ``[0, 2^64)``: ``[2]`` int64 words (high word, low word)."""
    return torch.tensor([(seed >> 32) & MASK32, seed & MASK32], dtype=torch.int64, device=device)


def split(key_: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``[2]`` -> ``[num, 2]`` int64 keys."""
    k = key_words(key_)
    idx = torch.arange(num, dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k[0], k[1], torch.zeros_like(idx), idx)
    return torch.stack([y0, y1], dim=-1)


def bernoulli(key_: torch.Tensor, p: float, shape) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` with a Python float ``p``
    (taken as a float32, as JAX takes it): a bool tensor of ``shape``."""
    n = int(np.prod(shape))
    u = uniform(key_[None], n)[0]
    return (u < torch.tensor(np.float32(p), device=u.device)).reshape(tuple(shape))


def permutation(key_: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: a shuffle of ``arange(n)``,
    ``[n]`` int64."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, dtype=torch.int64, device=key_.device)
    k = key_words(key_)
    for _ in range(rounds):
        k, sub = split(k)
        order = torch.sort(random_bits(sub[None], n)[0], stable=True).indices
        x = x[order]
    return x
