"""The port's ``matmul`` and ``importance`` kernels, and the
channel-granularity ``sparse_dense`` that runs ``matmul``, against the
JAX package's.

Inputs are made with numpy from a seed and handed to both packages. On
the CPU the port's wrappers run their plain versions and the JAX
package's ``ops.matmul`` / ``ops.importance`` run their Pallas kernels
in interpret mode. Tolerances: the JAX package's own kernel tests'
(fp32 1e-5, bf16 2e-2) for the kernels; 1e-4 for the gradients, after
the kept channels are compared.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy as jpolicy
from repro.core import sparse_dense as jdense
from repro.core import sparsity as jsparsity
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import backward as tbackward
from repro_torch.core import policy as tpolicy
from repro_torch.core.dense import sparse_dense as tdense
from repro_torch.kernels import gathered_matmul as tgm
from repro_torch.kernels import ops as tops

_DT = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
_TOL = {"float32": dict(rtol=1e-5, atol=1e-3), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a torch and a JAX array of ``dtype`` (bf16
    rounded once, in torch, and handed to JAX through fp32)."""
    t = torch.from_numpy(a).to(_DT[dtype][0])
    return t, jnp.asarray(t.float().numpy()).astype(_DT[dtype][1])


# --- the kernels ------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (200, 384, 130), (64, 256, 512)])
def test_matmul_matches_jax(m, k, n, dtype):
    """tests/test_kernels.py's ragged shapes: the plain version against
    the JAX package's kernel and its plain oracle; fp32 out."""
    rng = np.random.default_rng(5)
    a, aj = _pair(rng.standard_normal((m, k)).astype(np.float32), dtype)
    b, bj = _pair(rng.standard_normal((k, n)).astype(np.float32), dtype)
    out = tops.matmul(a, b)
    assert out.dtype == torch.float32 and tuple(out.shape) == (m, n)
    for expect in (jops.matmul(aj, bj), jref.matmul_ref(aj, bj)):
        np.testing.assert_allclose(out.numpy(), np.asarray(expect, np.float32), **_TOL[dtype])


def test_matmul_takes_strided_operands():
    """The backward hands over transposed views (``w_k.T``, ``x2.T``):
    the wrapper passes them as they are, and so does the plain version."""
    rng = np.random.default_rng(6)
    x2 = torch.from_numpy(rng.standard_normal((50, 33)).astype(np.float32))
    dy_k = torch.from_numpy(rng.standard_normal((50, 7)).astype(np.float32))
    out = tops.matmul(x2.T, dy_k)
    np.testing.assert_array_equal(out.numpy(), (x2.T.contiguous() @ dy_k).numpy())
    mixed = tops.matmul(x2.T.bfloat16(), dy_k)  # promoted to one operand type
    assert mixed.dtype == torch.float32
    with pytest.raises(ValueError, match="matmul"):
        tgm.matmul(x2, dy_k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n", [(256, 128), (300, 130), (512, 512)])
def test_importance_matches_jax(m, n, dtype):
    rng = np.random.default_rng(4)
    dy, dyj = _pair(rng.standard_normal((m, n)).astype(np.float32), dtype)
    out = tops.importance(dy)
    assert out.dtype == torch.float32 and tuple(out.shape) == (n,)
    for expect in (jops.importance(dyj), jref.importance_ref(dyj)):
        np.testing.assert_allclose(out.numpy(), np.asarray(expect), rtol=2e-3, atol=1e-4)
    # leading axes fold into rows, as the JAX wrapper's do
    np.testing.assert_allclose(tops.importance(dy.reshape(2, m // 2, n)).numpy(), out.numpy(),
                               rtol=1e-6)


def test_wrappers_refuse_other_devices_and_plain_versions_count_nothing():
    z = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tgm.matmul(z, z.T)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tgm.importance(z)
    before = dict(tgm.launches)
    a = torch.ones((3, 5))
    tops.matmul(a, a.T)
    tops.importance(a)
    assert tgm.launches == before


# --- sparse_dense at channel granularity --------------------------------

ROUTES = {"gather": {}, "matmul": {"use_pallas": True}, "mask": {"mask_mode": True}}
FLAGS = {"both": {}, "dx_only": {"sparsify_dw": False}, "dw_only": {"sparsify_dx": False}}


def _dense_case(bias: bool):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 24)).astype(np.float32)
    w = (rng.standard_normal((24, 40)) * 0.2).astype(np.float32)
    w *= (1.2 ** rng.permutation(40)).astype(np.float32)[None, :]  # no top-k near-ties
    b = (rng.standard_normal((40,)) * 0.1).astype(np.float32) if bias else None
    return x, w, b


@pytest.mark.parametrize("flags", sorted(FLAGS))
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("rate", [0.5, 0.8])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_channel_sparse_dense_grads_match_jax(route, rate, bias, flags):
    """dx, dw (and db) of ``0.5 * mean(y^2)`` at channel granularity: the
    kept channels first (the port's recorded selection against the JAX
    package's on the same dY, and the nonzero columns of dW), then the
    gradients at 1e-4."""
    x, w, b = _dense_case(bias)
    kw = dict(drop_rate=rate, granularity="channel", **ROUTES[route], **FLAGS[flags])
    jpol, tpol = jpolicy.SsPropPolicy(**kw), tpolicy.SsPropPolicy(**kw)

    def jloss(x, w, b):
        return 0.5 * (jdense(x, w, b, policy=jpol) ** 2).mean()

    args = [jnp.asarray(a) for a in (x, w, b) if a is not None]
    argnums = tuple(range(len(args)))
    gj = jax.jit(jax.grad(lambda *a: jloss(a[0], a[1], a[2] if bias else None),
                          argnums=argnums))(*args)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, b) if a is not None]
    with tbackward.record_selections() as log:
        y = tdense(ts[0], ts[1], ts[2] if bias else None, policy=tpol)
        (0.5 * (y**2).mean()).backward()
    (_, sel), = log
    dy = y.detach().reshape(-1, 40) / y.numel()  # the cotangent the backward saw
    sj = jsparsity.select(jnp.asarray(dy.numpy()), jpol, channel_axis=1)
    np.testing.assert_array_equal(sel.idx.numpy(), np.asarray(sj.idx))
    assert sel.k == tpol.keep_count(40)
    if tpol.sparsify_dw:  # dropped columns of dW exactly 0, kept ones not
        cols = np.flatnonzero(np.abs(ts[1].grad.numpy()).sum(0))
        np.testing.assert_array_equal(cols, sel.idx.numpy())
    for name, t, r in zip(("dx", "dw", "db"), ts, gj, strict=False):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_kernel_route_calls_matmul_once_a_side(monkeypatch):
    """With ``use_pallas`` each sparsified side is one ``matmul`` call on
    the gathered operands; without it, none."""
    calls = []
    real = tops.matmul

    def spy(a, b):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return real(a, b)

    monkeypatch.setattr(tops, "matmul", spy)
    x = torch.randn(16, 24, dtype=torch.bfloat16, requires_grad=True)
    w = torch.randn(24, 40, dtype=torch.bfloat16, requires_grad=True)
    for flags, expect in (({}, [((16, 8), (8, 24)), ((24, 16), (16, 8))]),
                          ({"sparsify_dw": False}, [((16, 8), (8, 24))]),
                          ({"sparsify_dx": False}, [((24, 16), (16, 8))])):
        calls.clear()
        pol = tpolicy.SsPropPolicy(0.8, use_pallas=True, **flags)
        tdense(x, w, policy=pol).float().square().sum().backward()
        assert calls == expect
    calls.clear()
    tdense(x, w, policy=tpolicy.SsPropPolicy(0.8)).float().square().sum().backward()
    assert calls == []


def test_sparse_dense_without_grad_is_the_plain_product():
    """Serving asks for no gradient: the forward is ``x @ w + b`` and does
    not enter the autograd Function."""
    x, w, b = (torch.from_numpy(a) for a in _dense_case(True))
    y = tdense(x, w, b, policy=tpolicy.paper_default(0.8))
    assert y.grad_fn is None
    np.testing.assert_array_equal(y.numpy(), (x @ w + b).numpy())
    with torch.no_grad():
        y2 = tdense(x, w.requires_grad_(True), b, policy=tpolicy.paper_default(0.8))
    assert y2.grad_fn is None and torch.equal(y2, y)
