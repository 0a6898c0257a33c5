"""The port's top-k gradient compression against the JAX package's.

``topk_compress``, and ``compress_tree`` with error feedback over a
params-shaped tree of dicts and per-layer lists (fp32 and bf16 leaves,
leaves under ``min_size`` passing whole): the compressed values, the
residuals and ``compressed_bytes`` equal the JAX package's on the same
numpy inputs, over three steps of carried residual; and the twin of
``tests/test_properties.py``'s error-feedback invariant, grad ==
compressed + residual exactly.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import compression as jcomp
from repro_torch.optim import compression as tcomp


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _grads(seed):
    """A params-shaped tree: a dict of layers in a list, bf16 and fp32
    leaves, a ssProp-like dW with dropped (all-zero) columns, small norms."""
    rng = np.random.default_rng(seed)
    dw = rng.standard_normal((64, 96)).astype(np.float32)
    dw[:, rng.permutation(96)[:72]] = 0.0
    return {
        "embed": {"table": rng.standard_normal((128, 64)).astype(ml_dtypes.bfloat16)},
        "layers": [{"w": dw, "norm": rng.standard_normal(64).astype(np.float32)},
                   {"w": rng.standard_normal((96, 64)).astype(np.float32),
                    "norm": rng.standard_normal(64).astype(np.float32)}],
    }


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("k", [1, 7, 100, 5000])
def test_topk_compress_matches_jax(k):
    g = np.random.default_rng(k).standard_normal((40, 50)).astype(np.float32)
    ours = tcomp.topk_compress(torch.from_numpy(g), k)
    ref = jcomp.topk_compress(jnp.asarray(g), k)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert int((ours != 0).sum()) == min(k, g.size)


@pytest.mark.parametrize("ratio,min_size", [(0.01, 4096), (0.05, 100), (0.3, 16)])
def test_compress_tree_matches_jax_over_steps(ratio, min_size):
    jres = jcomp.init_residual(jax.tree.map(jnp.asarray, _grads(0)))
    tres = tcomp.init_residual(jax.tree.map(_to_torch, _grads(0)))
    for step in range(3):
        g = _grads(step + 1)
        jc, jres = jcomp.compress_tree(jax.tree.map(jnp.asarray, g), jres, ratio=ratio,
                                       min_size=min_size)
        tc, tres = tcomp.compress_tree(jax.tree.map(_to_torch, g), tres, ratio=ratio,
                                       min_size=min_size)
        for a, b in zip(_leaves(tc) + _leaves(tres), _leaves(jc) + _leaves(jres), strict=True):
            b = np.asarray(b)
            assert _np(a).dtype == b.dtype and _np(a).shape == b.shape
            np.testing.assert_array_equal(_np(a).astype(np.float32), b.astype(np.float32))
    assert tcomp.compressed_bytes(tc, ratio, min_size) == \
        jcomp.compressed_bytes(jc, ratio, min_size)


def test_compressed_bytes_counts_values_and_indices():
    tree = {"big": torch.zeros(100, 100), "half": torch.zeros(5000, dtype=torch.bfloat16),
            "small": [torch.zeros(10)]}
    # 1% of each big leaf, a value and an int32 index each; the small one whole
    assert tcomp.compressed_bytes(tree, 0.01) == 100 * (4 + 4) + 50 * (2 + 4) + 10 * 4


@pytest.mark.parametrize("seed", range(5))
def test_compression_error_feedback_conserves_mass(seed):
    """grad == compressed + residual exactly (the error-feedback invariant),
    the twin of ``tests/test_properties.py``'s."""
    rng = np.random.default_rng(seed)
    ratio = float(rng.uniform(0.01, 0.5))
    g = {"a": torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))}
    cg, res = tcomp.compress_tree(g, tcomp.init_residual(g), ratio=ratio, min_size=16)
    assert torch.equal(cg["a"] + res["a"], g["a"])
    assert int((cg["a"] != 0).sum()) == max(1, int(64 * 64 * ratio))
