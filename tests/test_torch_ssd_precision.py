"""The SSD scan's precision at full-size chunks, on the CPU.

``models/ssm.py::ssd_chunked`` takes each within-chunk log-decay as a
segment sum of ``dt * a`` (a cumsum of it masked past the segment's
start), where the JAX package takes the difference of two prefix sums.
At the reduced configs' 16-token chunks the two agree to rounding; at
mamba2's 256-token chunks the difference's backward cancels large terms
and leaves the ``A_log`` gradient with a relative error of ~4e-4, which
parted the kernel, gather and mask routes of a full-width mamba2 step
past their 1e-4 gate. Here, at 256-token chunks in fp32:

* the forward equals the JAX package's ``ssd_chunked`` and a float64
  sequential scan (the recurrence's definition);
* every input's gradient, ``A_log``'s included, is within 1e-5 of the
  float64 scan's;
* one sparse training step of a mamba2 config with 256-token chunks
  keeps the same channels on the gather and the mask route, and every
  ``A_log`` leaf agrees within 1e-5 across them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.configs.registry import get_config
from repro_torch.core import backward
from repro_torch.core import policy as tpolicy
from repro_torch.data.pipeline import TokenPipeline, TokenPipelineConfig
from repro_torch.launch import steps
from repro_torch.models import model as tlm
from repro_torch.models import ssm

B, L, H, P, N, CHUNK = 2, 512, 4, 16, 8, 256
TOL = 1e-5


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return dict(
        x=rng.standard_normal((B, L, H, P)).astype(np.float32),
        dt=np.log1p(np.exp(rng.standard_normal((B, L, H)) - 2.0)).astype(np.float32),
        a_log=np.log(np.linspace(1.0, 16.0, H)).astype(np.float32),
        b=rng.standard_normal((B, L, N)).astype(np.float32),
        c=rng.standard_normal((B, L, N)).astype(np.float32),
        w=rng.standard_normal((B, L, H, P)).astype(np.float32),  # the output's cotangent
    )


def _sequential(x, dt, a_log, b, c):
    """The recurrence itself, position by position: ``s_t = exp(dt_t a)
    s_{t-1} + B_t (dt_t x_t)``, ``y_t = C_t . s_t``."""
    a = -torch.exp(a_log)
    s = torch.zeros((B, H, N, P), dtype=x.dtype)
    ys = []
    for t in range(L):
        s = torch.exp(dt[:, t] * a)[..., None, None] * s + torch.einsum(
            "bn,bhp->bhnp", b[:, t], dt[:, t, :, None] * x[:, t])
        ys.append(torch.einsum("bn,bhnp->bhp", c[:, t], s))
    return torch.stack(ys, dim=1)


def _grads(fn, inputs, dtype):
    names = ("x", "dt", "a_log", "b", "c")
    ts = {k: torch.tensor(inputs[k], dtype=dtype, requires_grad=True) for k in names}
    y = fn(*(ts[k] for k in names))
    (y.double() * torch.tensor(inputs["w"], dtype=torch.float64)).sum().backward()
    return y.detach().double().numpy(), {k: ts[k].grad.double().numpy() for k in names}


def test_the_scan_and_its_gradients_at_256_token_chunks(inputs):
    y, g = _grads(lambda *a: ssm.ssd_chunked(*a, CHUNK), inputs, torch.float32)
    y64, g64 = _grads(_sequential, inputs, torch.float64)
    jy = np.asarray(jssm.ssd_chunked(*(jnp.asarray(inputs[k]) for k in ("x", "dt", "a_log",
                                                                      "b", "c")), CHUNK))
    assert _rel(y, y64) <= TOL
    assert _rel(y, jy) <= TOL
    for k in g:
        assert _rel(g[k], g64[k]) <= TOL, (k, _rel(g[k], g64[k]))


def test_the_routes_keep_a_log_together_at_256_token_chunks():
    """Two layers of a mamba2 config at its full 256-token chunk (widths
    cut), B=2, S=512: one sparse step at ``paper_default(0.8)`` on the
    gather route and on the mask oracle."""
    cfg = dataclasses.replace(get_config("mamba2-1.3b").reduced(), ssm_chunk=CHUNK,
                              d_model=128, ssm_headdim=64, ssm_state=32)
    params = tlm.params_from_jax(
        cfg, jax.tree.map(np.asarray, _jax_init(cfg)), device="cpu")
    pipe = TokenPipeline(TokenPipelineConfig(cfg.vocab, 512, 2, 0))
    batch = {k: torch.from_numpy(v) for k, v in pipe.batch_at(0).items()}
    pol = tpolicy.paper_default(0.8)
    res = {}
    for name, p in (("gather", pol), ("mask", dataclasses.replace(pol, mask_mode=True))):
        with backward.record_selections() as log:
            _, grads = steps.value_and_grad(lambda q, p=p: tlm.loss_fn(cfg, q, batch, p), params)
        res[name] = ([s.idx.tolist() for _, s in log],
                     [layer["ssm"]["A_log"].numpy() for layer in grads["stack"]["layers"]])
    assert res["gather"][0] == res["mask"][0]
    for a, b in zip(res["gather"][1], res["mask"][1], strict=True):
        assert _rel(a, b) <= TOL


def _jax_init(cfg):
    from repro.configs.registry import get_config as jget
    from repro.models import model as jlm

    jcfg = dataclasses.replace(jget("mamba2-1.3b").reduced(), ssm_chunk=CHUNK, d_model=128,
                               ssm_headdim=64, ssm_state=32)
    assert (jcfg.d_inner, jcfg.n_ssm_heads) == (cfg.d_inner, cfg.n_ssm_heads)
    return jlm.init_params(jcfg, jax.random.PRNGKey(0))
