"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda``: it needs a CUDA card and skips
without one (a CUDA kernel has no CPU mode). The file imports neither
JAX nor the JAX package, so it also runs where only PyTorch is
installed (``--noconftest`` skips the JAX-importing ``conftest.py``):

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_attention as tpa

pytestmark = pytest.mark.cuda

_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(dev, *, b=4, s=3, h=16, kv=2, d=128, n_pages=24, bs=16, nb=6,
            q_dtype="bfloat16", pool_dtype="float32", seed=22):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((n_pages, bs, kv, d)).astype(np.float32)
    v = rng.standard_normal((n_pages, bs, kv, d)).astype(np.float32)
    tables = rng.integers(0, n_pages, (b, nb)).astype(np.int32)
    t = nb * bs
    offs = [7, 2 * bs, t - s, t // 2 + 3][:b]  # mid-page, page boundary, deep, middle
    qpos = (np.asarray(offs)[:, None] + np.arange(s)).astype(np.int32)
    return (
        torch.from_numpy(q).to(dev, _DT[q_dtype]),
        torch.from_numpy(k).to(dev, _DT[pool_dtype]),
        torch.from_numpy(v).to(dev, _DT[pool_dtype]),
        torch.from_numpy(tables).to(dev),
        torch.from_numpy(qpos).to(dev),
    )


@pytest.mark.parametrize("q_dtype,pool_dtype", [
    ("bfloat16", "float32"), ("float32", "float32"),
    ("bfloat16", "bfloat16"), ("float32", "bfloat16"),
])
@pytest.mark.parametrize("d,bs,s", [(128, 16, 1), (128, 16, 32), (32, 4, 5), (32, 8, 2), (128, 8, 3)])
def test_kernel_matches_plain(cuda, q_dtype, pool_dtype, d, bs, s):
    """Raw fp32 outputs at rtol=atol=1e-4 (summation order), and one
    launch counted per call."""
    args = _inputs(cuda, d=d, bs=bs, s=s, q_dtype=q_dtype, pool_dtype=pool_dtype)
    before = tpa.launches
    out = tpa.paged_attention(*args)
    torch.cuda.synchronize()
    assert tpa.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == args[0].shape
    torch.testing.assert_close(out, tpa.paged_attention_ref(*args), rtol=1e-4, atol=1e-4)


def test_kernel_ignores_garbage_table_entries(cuda):
    q, k, v, tables, _ = _inputs(cuda, s=1)
    qpos = torch.tensor([[2], [5], [17], [30]], dtype=torch.int32, device=cuda)
    bad = tables.clone()
    bad[:, 2:] = torch.tensor([999, -7, 999, -7], dtype=torch.int32, device=cuda)[:, None]
    assert torch.equal(tpa.paged_attention(q, k, v, tables, qpos),
                       tpa.paged_attention(q, k, v, bad, qpos))


def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    q, k, v, tables, qpos = _inputs(cuda)
    with pytest.raises(TypeError):
        tpa.paged_attention(q.half(), k, v, tables, qpos)
    with pytest.raises(TypeError):
        tpa.paged_attention(q, k, v, tables.long(), qpos)
    with pytest.raises(ValueError):
        tpa.paged_attention(q, k, v, tables.t().contiguous().t(), qpos)
    with pytest.raises(ValueError):
        tpa.paged_attention(q, k.cpu(), v.cpu(), tables, qpos)
    q64, k64, v64, _, _ = _inputs(cuda, d=64)  # no ported config has head_dim 64
    with pytest.raises(ValueError, match="head_dim"):
        tpa.paged_attention(q64, k64, v64, tables, qpos)
