"""The port's sampling against ``jax.random`` and the JAX package's steps.

``repro_torch.core.prng`` must give ``jax.random``'s bits exactly
(threefry in jax's partitionable layout), and
``repro_torch.launch.steps.sample_tokens`` / ``sample_tokens_chunk``
the JAX package's tokens on the same numpy logits. A Gumbel draw goes
through ``log``, whose last bit may differ between XLA and PyTorch, so
rows whose two best perturbed scores lie within 1e-5 of each other are
left out of the token comparison and counted (none is expected at these
sizes).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as jsteps
from repro.serve.request import SamplingParams as JaxSamplingParams
from repro_torch.core import prng
from repro_torch.launch import steps as tsteps
from repro_torch.serve.request import SamplingParams

TIE = 1e-5
V = 512  # the reduced config's padded vocabulary


def _keys(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32)


def test_jax_threefry_is_partitionable():
    """The layout ``prng.random_bits`` reproduces; an upgrade of JAX that
    flips it shows up here."""
    assert jax.config.jax_threefry_partitionable


def test_fold_in_matches_jax():
    keys = _keys(256, 0)
    data = np.random.default_rng(1).integers(0, 2**31, 256).astype(np.int32)
    data[:4] = [0, 1, 2**31 - 1, 24]
    ref = np.asarray(jax.vmap(jax.random.fold_in)(jnp.asarray(keys), jnp.asarray(data)))
    out = prng.fold_in(torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(data))
    np.testing.assert_array_equal(out.numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("n", [1, 7, 512, 1000])
def test_random_bits_match_jax(n):
    keys = _keys(128, n)
    ref = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (n,), jnp.uint32))(jnp.asarray(keys)))
    out = prng.random_bits(torch.from_numpy(keys.astype(np.int64)), n)
    np.testing.assert_array_equal(out.numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (float(np.finfo(np.float32).tiny), 1.0), (-2.0, 3.5)])
def test_uniform_matches_jax_bit_for_bit(lo, hi):
    keys = _keys(128, 3)
    ref = np.asarray(jax.vmap(
        lambda k: jax.random.uniform(k, (V,), jnp.float32, lo, hi))(jnp.asarray(keys)))
    out = prng.uniform(torch.from_numpy(keys.astype(np.int64)), V, lo, hi).numpy()
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))


def test_gumbel_matches_jax_to_the_last_bits():
    keys = _keys(128, 4)
    ref = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (V,), jnp.float32))(jnp.asarray(keys)))
    out = prng.gumbel(torch.from_numpy(keys.astype(np.int64)), V).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_categorical_matches_jax():
    keys = _keys(400, 5)
    logits = np.random.default_rng(6).standard_normal((400, V)).astype(np.float32) * 3
    ref = np.asarray(jax.vmap(jax.random.categorical)(jnp.asarray(keys), jnp.asarray(logits)))
    kt = torch.from_numpy(keys.astype(np.int64))
    out = prng.categorical(kt, torch.from_numpy(logits)).numpy()
    pert = np.sort(prng.gumbel(kt, V).numpy() + logits, axis=-1)
    clear = pert[:, -1] - pert[:, -2] > TIE
    assert clear.sum() >= 200
    np.testing.assert_array_equal(out[clear], ref[clear])


@pytest.mark.parametrize("seed", [0, 1, 2**31 - 1, 2**40 + 5])
def test_key_data_is_jax_prng_key(seed):
    """The JAX package's lane words, which are ``PRNGKey(seed)``'s for
    the 32-bit seeds the workloads draw (without x64, JAX truncates a
    wider seed before making the key)."""
    ours = SamplingParams(temperature=1.0, seed=seed).key_data()
    np.testing.assert_array_equal(ours, JaxSamplingParams(seed=seed).key_data())
    if seed < 2**32:
        np.testing.assert_array_equal(ours, np.asarray(jax.random.PRNGKey(seed)))


_JAX_SAMPLE = jax.jit(jsteps.sample_tokens)
_JAX_SAMPLE_CHUNK = jax.jit(jsteps.sample_tokens_chunk)


def _controls(rows, temperature, top_k, top_p, seed):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((rows, V)) * 2.5).astype(np.float32)
    logits[:, 500:] = -1e30  # padded ids, as the unembedding masks them
    temps = np.full((rows,), temperature, np.float32)
    temps[::5] = 0.0  # some greedy rows in every batch
    return dict(
        logits=logits,
        temps=temps,
        top_ks=np.full((rows,), top_k, np.int32),
        top_ps=np.full((rows,), top_p, np.float32),
        rng=_keys(rows, seed + 1),
        fold=rng.integers(0, 4096, rows).astype(np.int32),
    )


def _clear_rows(c):
    """The rows whose two best perturbed scores (the truncated logits
    plus the Gumbel draw) lie more than ``TIE`` apart: the rows the token
    comparison holds."""
    t = _torch_args(c)
    scaled = tsteps.truncated_logits(torch.from_numpy(c["logits"]), t["temps"], t["top_ks"],
                                     t["top_ps"])
    g = prng.gumbel(prng.fold_in(t["rng"], torch.from_numpy(c["fold"])), V)
    pert = np.sort((scaled + g).numpy(), axis=-1)
    return pert[:, -1] - pert[:, -2] > TIE


def _torch_args(c):
    return dict(
        rng=torch.from_numpy(c["rng"].astype(np.int64)),
        temps=torch.from_numpy(c["temps"]),
        top_ks=torch.from_numpy(c["top_ks"].astype(np.int64)),
        top_ps=torch.from_numpy(c["top_ps"]),
    )


@pytest.mark.parametrize("top_p", [0.5, 0.95, 1.0])
@pytest.mark.parametrize("top_k", [0, 1, 50, 128])
@pytest.mark.parametrize("temperature", [0.5, 1.0, 1.7])
def test_sample_tokens_matches_jax(temperature, top_k, top_p):
    """64 rows a case (every fifth greedy), 500 real ids and 12 padded
    ones at -1e30: the same tokens as the JAX step's, near ties left out."""
    c = _controls(64, temperature, top_k, top_p, seed=int(temperature * 10) + top_k + int(top_p * 100))
    ref = np.asarray(_JAX_SAMPLE(
        jnp.asarray(c["logits"]), rng=jnp.asarray(c["rng"]), temps=jnp.asarray(c["temps"]),
        top_ks=jnp.asarray(c["top_ks"]), top_ps=jnp.asarray(c["top_ps"]),
        fold=jnp.asarray(c["fold"])))
    out = tsteps.sample_tokens(
        torch.from_numpy(c["logits"]), fold=torch.from_numpy(c["fold"]), **_torch_args(c)
    ).numpy()
    clear = _clear_rows(c) | (c["temps"] == 0)
    assert clear.sum() >= 60, f"{64 - clear.sum()} near ties"
    np.testing.assert_array_equal(out[clear], ref[clear])
    assert out.dtype == np.int32 and (out[c["temps"] == 0] == c["logits"].argmax(-1)[c["temps"] == 0]).all()
    if top_k == 1:  # one candidate left: sampling is the argmax
        np.testing.assert_array_equal(out, c["logits"].argmax(-1))


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (50, 0.95)])
def test_sample_tokens_chunk_matches_jax(top_k, top_p):
    """A [B, C] chunk with per-position folds: JAX's tokens, and each
    position the width-1 draw at its fold."""
    b, ch = 6, 5
    c = _controls(b * ch, 0.9, top_k, top_p, seed=31)
    for k in ("temps", "top_ks", "top_ps", "rng"):
        c[k] = c[k][::ch]  # one control set a slot
    c["temps"][:] = 0.9
    c["temps"][2] = 0.0
    fold = (np.arange(b)[:, None] * 100 + np.arange(ch)[None, :]).astype(np.int32)
    logits = c["logits"].reshape(b, ch, V)
    ref = np.asarray(_JAX_SAMPLE_CHUNK(
        jnp.asarray(logits), rng=jnp.asarray(c["rng"]), temps=jnp.asarray(c["temps"]),
        top_ks=jnp.asarray(c["top_ks"]), top_ps=jnp.asarray(c["top_ps"]), fold=jnp.asarray(fold)))
    out = tsteps.sample_tokens_chunk(
        torch.from_numpy(logits), fold=torch.from_numpy(fold), **_torch_args(c)).numpy()
    flat = {k: np.repeat(c[k], ch, axis=0) for k in ("temps", "top_ks", "top_ps", "rng")}
    clear = _clear_rows(dict(flat, logits=c["logits"], fold=fold.reshape(-1))).reshape(b, ch)
    clear |= (c["temps"] == 0)[:, None]
    assert clear.sum() >= b * ch - 2
    np.testing.assert_array_equal(out[clear], ref[clear])
    for j in range(ch):
        one = tsteps.sample_tokens(torch.from_numpy(logits[:, j]),
                                   fold=torch.from_numpy(fold[:, j]), **_torch_args(c)).numpy()
        np.testing.assert_array_equal(out[:, j], one)


def test_emit_tokens_samples_only_the_sampled_rows():
    """The slot step draws for the rows with temperature > 0 and takes the
    argmax elsewhere, as one ``sample_tokens`` call over every row does;
    without sampling tensors in the state it is the argmax."""
    c = _controls(16, 1.2, 50, 0.9, seed=40)
    t = torch.from_numpy(c["logits"])
    fold = torch.from_numpy(c["fold"])
    whole = tsteps.sample_tokens(t, fold=fold, **_torch_args(c))
    np.testing.assert_array_equal(tsteps._emit_tokens(t, _torch_args(c), fold).numpy(), whole.numpy())
    np.testing.assert_array_equal(tsteps._emit_tokens(t, {}, fold).numpy(), c["logits"].argmax(-1))
