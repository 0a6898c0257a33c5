"""The port's paged attention against the JAX package's.

On the CPU the port's wrapper takes its plain version; the JAX side runs
its Pallas kernel in interpret mode (``repro.kernels.ops`` picks that
off the TPU), as ``tests/test_kernels.py`` does. Inputs are made with
numpy from a seed and handed to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa

_TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _case(seed, b, s, h, kv, d, n_pages, bs_pg, nb):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k_pool = rng.standard_normal((n_pages, bs_pg, kv, d)).astype(np.float32)
    v_pool = rng.standard_normal((n_pages, bs_pg, kv, d)).astype(np.float32)
    tables = rng.integers(0, n_pages, (b, nb)).astype(np.int32)
    return q, k_pool, v_pool, tables


def _both(q, k_pool, v_pool, tables, qpos, dtype):
    jdt = jnp.dtype(dtype)
    out_j = jops.paged_attention(
        jnp.asarray(q, jdt), jnp.asarray(k_pool, jdt), jnp.asarray(v_pool, jdt),
        jnp.asarray(tables), jnp.asarray(qpos),
    )
    tdt = _TORCH_DT[dtype]
    out_t = tops.paged_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k_pool).to(tdt),
        torch.from_numpy(v_pool).to(tdt), torch.from_numpy(tables),
        torch.from_numpy(qpos),
    )
    return np.asarray(out_j, np.float32), out_t.float().numpy(), out_t.dtype


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kv,s", [(4, 2, 2), (4, 4, 1)])
def test_paged_attention_matches_jax(dtype, h, kv, s):
    """The grid of ``tests/test_kernels.py::test_paged_attention_vs_gather``:
    slots mid-page, on a page boundary and deep."""
    b, d, n_pages, bs_pg, nb = 3, 8, 10, 4, 3
    q, k_pool, v_pool, tables = _case(20, b, s, h, kv, d, n_pages, bs_pg, nb)
    qpos = np.stack([np.arange(s) + off for off in (1, 4, 7)]).astype(np.int32)
    out_j, out_t, out_dtype = _both(q, k_pool, v_pool, tables, qpos, dtype)
    assert out_dtype == _TORCH_DT[dtype]  # cast back to q's dtype
    # fp32: summation order only; bf16: one bf16 rounding of the output
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(out_t, out_j, rtol=tol, atol=tol)


@pytest.mark.parametrize("h,kv,d", [(20, 20, 64), (8, 1, 256)])
def test_plain_version_at_whisper_and_paligemma_heads_matches_jax(h, kv, d):
    """The plain version at whisper's heads (H = KV = 20, D = 64) and
    paligemma's (8 query heads on one KV head, D = 256), 16-token pages,
    a decode row and a 3-row chunk a slot, against the Pallas kernel in
    interpret mode; fp32, summation order only."""
    b, n_pages, bs_pg, nb = 2, 8, 16, 4
    for s, offs in ((1, (9, 50)), (3, (16, 40))):
        q, k_pool, v_pool, tables = _case(22 + s, b, s, h, kv, d, n_pages, bs_pg, nb)
        qpos = np.stack([np.arange(s) + off for off in offs]).astype(np.int32)
        out_j, out_t, _ = _both(q, k_pool, v_pool, tables, qpos, "float32")
        np.testing.assert_allclose(out_t, out_j, rtol=1e-5, atol=1e-5)


def test_paged_attention_ignores_garbage_table_entries():
    """Entries past the causal horizon may be stale or out of range (999,
    -7): they are clipped, then fenced, so the output is unchanged — and
    it matches the JAX kernel given the same garbage."""
    b, s, h, kv, d = 2, 1, 4, 2, 8
    n_pages, bs_pg = 6, 4
    q, k_pool, v_pool, _ = _case(21, b, s, h, kv, d, n_pages, bs_pg, 3)
    qpos = np.asarray([[2], [5]], np.int32)  # pages 2+ never reached
    good = np.asarray([[0, 1, 2], [3, 4, 2]], np.int32)
    bad = good.copy()
    bad[:, 2] = [999, -7]
    out_j_bad, out_t_bad, _ = _both(q, k_pool, v_pool, bad, qpos, "float32")
    _, out_t_good, _ = _both(q, k_pool, v_pool, good, qpos, "float32")
    np.testing.assert_array_equal(out_t_bad, out_t_good)
    np.testing.assert_allclose(out_t_bad, out_j_bad, rtol=1e-5, atol=1e-5)


def test_wrapper_refuses_other_devices():
    """Only a CPU tensor takes the plain version; a tensor elsewhere is
    the kernel's or an error, never a silent fall-back."""
    q = torch.zeros((1, 1, 2, 32), device="meta")
    pool = torch.zeros((2, 4, 1, 32), device="meta")
    tables = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    qpos = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tpa.paged_attention(q, pool, pool, tables, qpos)


def test_build_is_keyed_by_source_hash():
    """One library per kernel source, named by its content hash, in the
    git-ignored build directory."""
    assert build.sources() == [
        "conv_dw_fused", "conv_dx_fused", "dw_gathered", "dx_gathered", "importance", "matmul",
        "paged_attention",
    ]
    path = build.lib_path("paged_attention")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("paged_attention-") and path.suffix == ".so"
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)
