"""The port's sharded selection against the JAX package's.

``shard_select_width`` over a grid of widths, shard counts and
policies; ``select`` / ``select_indices_per_shard`` at ``n_shards > 1``
for channel and block granularity, top-k and random selection (random
channel selection draws ``jax.random.uniform`` noise, the block branch
takes the top-k whatever ``selection`` says); shrunk shard blocks, with
``block_idx`` absent, and whole ones, with it regrouped; and
``mask_grad`` / ``select_indices``. Inputs are made with numpy from a
seed, with channel scales spread apart so that no top-k is a near-tie.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy as jpolicy
from repro.core import sparsity as jsparsity
from repro_torch.core import policy as tpolicy
from repro_torch.core import prng as tprng
from repro_torch.core import sparsity as tsparsity


def _separated(rng, shape, channel_axis=-1):
    c = shape[channel_axis]
    scale = 1.25 ** rng.permutation(c).astype(np.float32)
    sh = [1] * len(shape)
    sh[channel_axis] = c
    return (rng.standard_normal(shape) * scale.reshape(sh)).astype(np.float32)


def _pols(**kw):
    return jpolicy.SsPropPolicy(**kw), tpolicy.SsPropPolicy(**kw)


@pytest.mark.parametrize("gran", ["channel", "block"])
@pytest.mark.parametrize("rate", [0.5, 0.8, 0.95])
def test_shard_select_width_grid(gran, rate):
    for c in (16, 24, 64, 96, 256, 688 * 16, 2048):
        for s in (1, 2, 4, 8, 16):
            if c % s:
                continue
            for bs in (4, 16, 128):
                jp, tp = _pols(drop_rate=rate, granularity=gran, block_size=bs)
                assert tsparsity.shard_select_width(c, tp, s) == \
                    jsparsity.shard_select_width(c, jp, s), (c, s, bs)


# (granularity, block_size, C, n_shards, selection): shrunk shard blocks
# (C/S < bs or not a multiple), whole ones, and channel top-k / random
SHARD_CASES = [
    ("channel", 8, 32, 4, "topk"),
    ("channel", 8, 30, 3, "topk"),
    ("channel", 8, 32, 4, "random"),
    ("block", 8, 64, 2, "topk"),     # c_loc 32: whole 8-blocks, block_idx regrouped
    ("block", 8, 64, 2, "random"),   # block branch: top-k whatever selection says
    ("block", 16, 32, 4, "topk"),    # c_loc 8 < 16: shard block shrunk to 8, no block_idx
    ("block", 16, 48, 2, "topk"),    # c_loc 24: 16 does not tile it, shrunk to 8
    ("block", 4, 16, 2, "topk"),
]


@pytest.mark.parametrize("gran,bs,c,s,selection", SHARD_CASES)
def test_select_sharded_matches_jax(gran, bs, c, s, selection):
    rng = np.random.default_rng(c + s)
    dy = _separated(rng, (3, c, 2, 2), 1)
    jp, tp = _pols(drop_rate=0.5, granularity=gran, block_size=bs, selection=selection)
    jkey = jax.random.PRNGKey(7) if selection == "random" else None
    tkey = tprng.key(7) if selection == "random" else None
    sj = jsparsity.select(jnp.asarray(dy), jp, channel_axis=1, n_shards=s, key=jkey)
    st = tsparsity.select(torch.from_numpy(dy), tp, channel_axis=1, n_shards=s, key=tkey)
    assert (st.k, st.k_loc, st.n_shards) == (sj.k, sj.k_loc, sj.n_shards)
    np.testing.assert_array_equal(st.idx.numpy(), np.asarray(sj.idx))
    np.testing.assert_array_equal(st.shard_idx.numpy(), np.asarray(sj.shard_idx))
    assert (st.block_idx is None) == (sj.block_idx is None)
    if sj.block_idx is not None:
        np.testing.assert_array_equal(st.block_idx.numpy(), np.asarray(sj.block_idx))
        assert st.block_idx.dtype == torch.int32
    assert st.valid is None and sj.valid is None
    # balanced: every shard keeps k_loc of its own channels
    per = np.bincount(st.idx.numpy() // (c // s), minlength=s)
    assert (per == st.k_loc).all()


def test_random_channel_shard_noise_is_jax_uniform():
    """Channel ``random`` keeps the top-k of ``jax.random.uniform(key, [S,
    c_loc])``: the same kept channels for any importance."""
    rng = np.random.default_rng(0)
    dy2 = rng.standard_normal((5, 48)).astype(np.float32)
    jp, tp = _pols(drop_rate=0.75, selection="random")
    for seed in (0, 3, 11):
        ij, kj = jsparsity.select_indices_per_shard(jnp.asarray(dy2), jp, 4,
                                                    key=jax.random.PRNGKey(seed))
        it, kt = tsparsity.select_indices_per_shard(torch.from_numpy(dy2), tp, 4,
                                                    key=tprng.key(seed))
        assert kt == kj
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    with pytest.raises(ValueError, match="requires key"):
        tsparsity.select_indices_per_shard(torch.from_numpy(dy2), tp, 4)
    with pytest.raises(ValueError, match="shards"):
        tsparsity.select_indices_per_shard(torch.from_numpy(dy2), tp, 5)


@pytest.mark.parametrize("gran,bs,c", [("channel", 8, 20), ("block", 8, 32), ("block", 4, 10)])
def test_mask_grad_and_select_indices_match_jax(gran, bs, c):
    rng = np.random.default_rng(c)
    dy = _separated(rng, (6, c))
    jp, tp = _pols(drop_rate=0.5, granularity=gran, block_size=bs)
    ij, kj = jsparsity.select_indices(jnp.asarray(dy), jp)
    it, kt = tsparsity.select_indices(torch.from_numpy(dy), tp)
    assert kt == kj
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    mj = jsparsity.mask_grad(jnp.asarray(dy), jp)
    mt = tsparsity.mask_grad(torch.from_numpy(dy), tp)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    # masking twice is masking once; the inactive policy is the identity
    np.testing.assert_array_equal(tsparsity.mask_grad(mt, tp).numpy(), mt.numpy())
    x = torch.from_numpy(dy)
    assert tsparsity.mask_grad(x, tpolicy.SsPropPolicy(0.0)) is x
