"""Random channel selection and ResNet dropout, drawn as ``jax.random`` draws.

``repro_torch.core.prng`` reproduces ``jax.random.split``, ``bernoulli``
and ``permutation`` bit for bit; ``selection="random"`` picks the first K
of ``permutation(key, C)`` and the ResNet's dropout draws ``dk, sub =
split(dk)`` then ``bernoulli(sub, 1 - rate, h.shape)`` after each block,
as the JAX package does. Every check here is exact but the gradients,
held at a relative L2 of 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy as jpolicy
from repro.core import sparse_conv2d as jconv
from repro.core import sparse_dense as jdense
from repro.core import sparsity as jsparsity
from repro.models import resnet as jresnet
from repro_torch.core import policy as tpolicy
from repro_torch.core import prng
from repro_torch.core import sparsity as tsparsity
from repro_torch.core.conv import sparse_conv2d as tconv
from repro_torch.core.dense import sparse_dense as tdense
from repro_torch.launch import steps as tsteps
from repro_torch.models import resnet as tresnet
from repro_torch.optim import adam as tadam

SEEDS = (0, 7, 123456789, 2**31 - 1)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    n = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / n) if n > 0 else float(np.linalg.norm(a))


def _jkey(seed):
    return jax.random.PRNGKey(seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_bit_for_bit(seed):
    np.testing.assert_array_equal(prng.key(seed).numpy(),
                                  np.asarray(jax.random.key_data(_jkey(seed))))
    for num in (2, 3, 7):
        np.testing.assert_array_equal(prng.split(prng.key(seed), num).numpy(),
                                      np.asarray(jax.random.split(_jkey(seed), num)))
    # a split of a split: the chain the dropout walks
    k, jk = prng.key(seed), _jkey(seed)
    for _ in range(3):
        k, _ = prng.split(k)
        jk, _ = jax.random.split(jk)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))


@pytest.mark.parametrize("n", [0, 1, 2, 3, 17, 64, 500, 1625, 1626, 2048, 5000])
def test_permutation_bit_for_bit(n):
    """One sort round up to n = 1625, two past it."""
    for seed in SEEDS[:3]:
        np.testing.assert_array_equal(prng.permutation(prng.key(seed), n).numpy(),
                                      np.asarray(jax.random.permutation(_jkey(seed), n)))


@pytest.mark.parametrize("shape", [(7,), (4, 3, 5, 5), (2, 64, 8, 8)])
@pytest.mark.parametrize("p", [0.5, 0.7, 0.9, 1.0 - 0.3])
def test_bernoulli_bit_for_bit(shape, p):
    for seed in SEEDS[:2]:
        np.testing.assert_array_equal(prng.bernoulli(prng.key(seed), p, shape).numpy(),
                                      np.asarray(jax.random.bernoulli(_jkey(seed), p, shape)))


@pytest.mark.parametrize("c,k", [(40, 7), (96, 48), (2000, 400)])
def test_random_channel_selection_is_jax(c, k):
    imp = np.random.default_rng(c).random(c).astype(np.float32)
    for seed in SEEDS[:3]:
        ours = tsparsity.select_topk_channels(torch.from_numpy(imp), k, selection="random",
                                              key=prng.key(seed))
        ref = jsparsity.select_topk_channels(jnp.asarray(imp), k, selection="random",
                                             key=_jkey(seed))
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("c,bs,rate", [(256, 32, 0.5), (200, 32, 0.8), (64, 4, 0.75)])
def test_random_block_selection_is_jax(c, bs, rate):
    dy = np.random.default_rng(1).standard_normal((6, c)).astype(np.float32)
    kw = dict(granularity="block", block_size=bs, selection="random")
    for seed in SEEDS[:2]:
        st = tsparsity.select(torch.from_numpy(dy), tpolicy.SsPropPolicy(rate, **kw),
                              key=prng.key(seed))
        sj = jsparsity.select(jnp.asarray(dy), jpolicy.SsPropPolicy(rate, **kw), key=_jkey(seed))
        np.testing.assert_array_equal(st.block_idx.numpy(), np.asarray(sj.block_idx))
        np.testing.assert_array_equal(st.idx.numpy(), np.asarray(sj.idx))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_random_selection_dense_grads_match_jax(use_pallas):
    """``sparse_dense`` with ``selection="random"`` under a key: the same
    kept channels, so every gradient matches the JAX package's."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((16, 48)).astype(np.float32)
    w = rng.standard_normal((48, 96)).astype(np.float32)
    kw = dict(selection="random", use_pallas=use_pallas)
    jpol = dataclasses.replace(jpolicy.paper_default(0.5), **kw)
    tpol = dataclasses.replace(tpolicy.paper_default(0.5), **kw)
    gj = jax.grad(lambda x, w: (jdense(x, w, policy=jpol, key=_jkey(9)) ** 2).sum(),
                  argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    (tdense(xt, wt, policy=tpol, key=prng.key(9)) ** 2).sum().backward()
    assert _rel(xt.grad.numpy(), gj[0]) <= 1e-4 and _rel(wt.grad.numpy(), gj[1]) <= 1e-4
    kept = np.flatnonzero(np.abs(np.asarray(gj[1])).sum(0))
    np.testing.assert_array_equal(np.flatnonzero(wt.grad.abs().sum(0).numpy()), kept)


@pytest.mark.parametrize("granularity", ["channel", "block"])
def test_random_selection_conv_grads_match_jax(granularity):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 6, 6)).astype(np.float32)
    w = rng.standard_normal((64, 8, 3, 3)).astype(np.float32)
    kw = dict(selection="random", granularity=granularity, block_size=16)
    jpol, tpol = jpolicy.SsPropPolicy(0.5, **kw), tpolicy.SsPropPolicy(0.5, **kw)
    gj = jax.grad(lambda x, w: (jconv(x, w, padding=1, policy=jpol, key=_jkey(5)) ** 2).sum(),
                  argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    (tconv(xt, wt, padding=1, policy=tpol, key=prng.key(5)) ** 2).sum().backward()
    assert _rel(xt.grad.numpy(), gj[0]) <= 1e-4 and _rel(wt.grad.numpy(), gj[1]) <= 1e-4


def _resnet_pair(seed=0):
    pj = jresnet.init_params("resnet18", jax.random.PRNGKey(seed), num_classes=10)
    return pj, tresnet.params_from_jax("resnet18", jax.tree.map(np.asarray, pj), device="cpu")


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_resnet_dropout_masks_are_jax(rate, monkeypatch):
    """Every block's dropout mask, recorded as the port draws it in a
    forward pass, equals the JAX package's draw for that block (the key
    chain of ``repro/models/resnet.py``: ``dk, sub = split(dk)``, then
    ``bernoulli(sub, 1 - rate, h.shape)``) bit for bit. (The loss and
    gradients of a step with dropout, both packages' forward passes, are
    held together below.)"""
    pt = tresnet.init_params("resnet18", 0, device="cpu")
    x = np.random.default_rng(2).standard_normal((2, 3, 16, 16)).astype(np.float32)
    masks = []
    treal = prng.bernoulli
    monkeypatch.setattr(prng, "bernoulli", lambda *a, **k: masks.append(treal(*a, **k))
                        or masks[-1])
    with torch.no_grad():
        tresnet.forward("resnet18", pt, torch.from_numpy(x), dropout_rate=rate,
                             dropout_key=prng.key(11))
    assert len(masks) == len(jresnet.block_strides("resnet18"))
    dk = _jkey(11)
    for m in masks:
        dk, sub = jax.random.split(dk)
        np.testing.assert_array_equal(
            m.numpy(), np.asarray(jax.random.bernoulli(sub, 1.0 - rate, tuple(m.shape))))
    assert 0 < float(masks[0].float().mean()) < 1


def test_resnet_step_with_dropout_matches_jax():
    """One ResNet-18 step with dropout (rate 0.3) under ssProp: the loss and
    every gradient leaf match the JAX package's at a relative L2 of 1e-4.
    The JAX package's ``resnet.forward`` passes its convolutions no
    selection key, so the ResNet step runs top-k selection; random
    selection is held to JAX at every layer kind above."""
    pj, pt = _resnet_pair()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 3, 16, 16)).astype(np.float32)
    y = rng.integers(0, 10, 4).astype(np.int32)
    kw = dict(block_size=32)
    jpol = dataclasses.replace(jpolicy.tpu_default(0.8), **kw)
    tpol = dataclasses.replace(tpolicy.tpu_default(0.8), **kw)

    def loss_j(p):
        logits = jresnet.forward("resnet18", p, jnp.asarray(x), jpol, dropout_rate=0.3,
                                 dropout_key=_jkey(21))
        return -jax.nn.log_softmax(logits)[jnp.arange(4), jnp.asarray(y)].mean()

    lj, gj = jax.jit(jax.value_and_grad(loss_j))(pj)

    def loss_t(p):
        logits = tresnet.forward("resnet18", p, torch.from_numpy(x), tpol, dropout_rate=0.3,
                                 dropout_key=prng.key(21))
        return -torch.log_softmax(logits, -1)[torch.arange(4), torch.from_numpy(y).long()].mean(), {}

    (lt, _), gt = tsteps.value_and_grad(loss_t, pt)
    assert abs(float(lt) - float(lj)) <= 1e-4 * abs(float(lj))
    leaves_j, leaves_t = jax.tree.leaves(gj), tadam.tree_leaves(gt)
    assert len(leaves_j) == len(leaves_t)
    for a, b in zip(leaves_t, leaves_j, strict=True):
        assert _rel(a.numpy(), b) <= 1e-4
