"""DDPM (Ho et al. 2020) with a compact UNet: the paper's generation task.

The twin of ``repro.models.ddpm``: functional, dict params, NCHW. The
UNet is a conv stem, three resolution levels (down and up) of
GroupNorm + SiLU residual blocks with a sinusoidal time embedding added
after each block's first conv, skip concatenations between the levels,
and a GroupNorm + SiLU + conv head. It has no attention: the JAX
package's docstring names a bottleneck self-attention that its code does
not have, and the port follows the code. Every convolution goes through
:func:`repro_torch.models.layers.conv_apply` with its site name, so
ssProp applies to all of them (the paper puts 99.7 % of DDPM's FLOPs in
conv modules); the two time-embedding linears are plain matmuls, as in
the JAX package.

Training objective: epsilon-prediction MSE under the linear beta
schedule. ``jax.random`` cannot be matched, so :func:`loss_fn` takes the
timesteps and the noise explicitly (:func:`draw_t_noise` draws them from
a ``torch.Generator``) and :func:`sample` takes ``x_T`` and a per-step
noise source.

Beside the model: :func:`flops_per_iter`, the paper's backward-FLOPs
walk; :func:`backward_routes` and :func:`kernel_launches_per_step`, the
route of each conv under a policy and the launches of each gathered
kernel in a training step.
"""
from __future__ import annotations

from collections.abc import Callable
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import flops as FL
from repro_torch.core.conv import backward_route, route_launches
from repro_torch.core.policy import DENSE, PolicyLike, policy_for
from repro_torch.models import layers

# ----------------------------------------------------------------------
# diffusion schedule
# ----------------------------------------------------------------------


def make_schedule(timesteps: int, beta_start=1e-4, beta_end=2e-2, device="cuda"):
    """The linear beta schedule and its running products, fp32. The betas
    are interpolated as ``jnp.linspace`` does, ``start * (1 - s) + end * s``
    at ``s = i / (T - 1)``."""
    f32 = dict(dtype=torch.float32, device=device)
    s = torch.arange(timesteps - 1, **f32) / (timesteps - 1)
    start, end = torch.tensor(beta_start, **f32), torch.tensor(beta_end, **f32)
    betas = torch.cat([start * (1 - s) + end * s, end[None]])
    alphas = 1.0 - betas
    acp = torch.cumprod(alphas, dim=0)
    return {
        "betas": betas,
        "alphas": alphas,
        "acp": acp,
        "sqrt_acp": torch.sqrt(acp),
        "sqrt_1macp": torch.sqrt(1.0 - acp),
    }


def q_sample(sched, x0, t, noise):
    """``x_t`` of ``x0`` at timesteps ``t`` [B] under ``noise``."""
    t = t.long()
    return (
        sched["sqrt_acp"][t][:, None, None, None] * x0
        + sched["sqrt_1macp"][t][:, None, None, None] * noise
    )


def time_embedding(t, dim):
    """Sinusoidal embedding [B, dim] of the timesteps ``t`` [B]."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    ang = t[:, None].float() * freqs[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ----------------------------------------------------------------------
# UNet
# ----------------------------------------------------------------------


def _conv_init(gen, c_out, c_in, k=3, device="cuda"):
    return layers.conv2d_init(gen, c_out, c_in, k, bias=True, device=device)


def _lin_init(gen, d_in, d_out, device="cuda"):
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32, device=device)
    return {
        "w": w / math.sqrt(d_in),
        "b": torch.zeros((d_out,), dtype=torch.float32, device=device),
    }


def _gn(x, groups=8):
    """Affine-free GroupNorm over ``min(groups, C)`` groups: the biased
    variance and ``rsqrt(var + 1e-5)``."""
    return F.group_norm(x, min(groups, x.shape[1]), eps=1e-5)


def _resblock_init(gen, c_in, c_out, t_dim, device="cuda"):
    p = {
        "conv1": _conv_init(gen, c_out, c_in, device=device),
        "temb": _lin_init(gen, t_dim, c_out, device=device),
        "conv2": _conv_init(gen, c_out, c_out, device=device),
    }
    if c_in != c_out:
        p["skip"] = _conv_init(gen, c_out, c_in, 1, device=device)
    return p


def _resblock_apply(p, x, temb, policy, prefix):
    h = layers.conv_apply(p["conv1"], F.silu(_gn(x)), policy, padding=1, site=f"{prefix}/conv1")
    h = h + (F.silu(temb) @ p["temb"]["w"] + p["temb"]["b"])[:, :, None, None]
    h = layers.conv_apply(p["conv2"], F.silu(_gn(h)), policy, padding=1, site=f"{prefix}/conv2")
    if "skip" in p:
        x = layers.conv_apply(p["skip"], x, policy, site=f"{prefix}/skip")
    return x + h


def _widths(base: int) -> tuple[int, int, int]:
    return base, base * 2, base * 2


def init_params(
    seed: int = 0, *, channels: int = 1, base: int = 64, t_dim: int = 256, device="cuda"
) -> dict[str, Any]:
    """Random params with the JAX package's distributions (Kaiming-normal
    convs with zero biases, ``N(0, 1/d_in)`` linears with zero biases),
    drawn from a ``torch.Generator`` seeded with ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    c1, c2, c3 = _widths(base)
    kw = dict(device=device)
    return {
        "t1": _lin_init(gen, t_dim, t_dim, **kw),
        "t2": _lin_init(gen, t_dim, t_dim, **kw),
        "stem": _conv_init(gen, c1, channels, **kw),
        "down1": _resblock_init(gen, c1, c1, t_dim, **kw),
        "down2": _resblock_init(gen, c1, c2, t_dim, **kw),
        "down3": _resblock_init(gen, c2, c3, t_dim, **kw),
        "mid1": _resblock_init(gen, c3, c3, t_dim, **kw),
        "mid2": _resblock_init(gen, c3, c3, t_dim, **kw),
        "up3": _resblock_init(gen, c3 + c3, c2, t_dim, **kw),
        "up2": _resblock_init(gen, c2 + c2, c1, t_dim, **kw),
        "up1": _resblock_init(gen, c1 + c1, c1, t_dim, **kw),
        "out": _conv_init(gen, channels, c1, **kw),
    }


def params_from_jax(tree, device="cuda") -> dict[str, Any]:
    """The port's params from a JAX DDPM param tree whose leaves are numpy
    arrays (``jax.tree.map(np.asarray, params)``): the same nested dicts,
    leaf for leaf (OIHW conv filters, ``[d_in, d_out]`` linears,
    biases)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)


def _down(x):
    """2x2 max-pool, stride 2 ("VALID")."""
    return F.max_pool2d(x, 2)


def _up(x):
    """Nearest-neighbour upsampling by 2."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


BLOCKS = ("down1", "down2", "down3", "mid1", "mid2", "up3", "up2", "up1")


def site_names(base: int = 64):
    """``(sites, depth)``: the UNet's conv sites in forward order and its
    number of residual blocks, so ``{down1,up1}/*``-style rules address
    the outer levels."""
    c1, c2, c3 = _widths(base)
    chans = {
        "down1": (c1, c1), "down2": (c1, c2), "down3": (c2, c3),
        "mid1": (c3, c3), "mid2": (c3, c3),
        "up3": (c3 + c3, c2), "up2": (c2 + c2, c1), "up1": (c1 + c1, c1),
    }
    sites = ["stem"]
    for blk in BLOCKS:
        ci, co = chans[blk]
        sites += [f"{blk}/conv1", f"{blk}/conv2"]
        if ci != co:
            sites.append(f"{blk}/skip")
    sites.append("out")
    return tuple(sites), len(BLOCKS)


def forward(params, x, t, policy: PolicyLike = DENSE):
    """Predict epsilon: x [B, C, H, W], t [B] integer timesteps."""
    td = params["t1"]["w"].shape[0]
    temb = time_embedding(t, td)
    temb = F.silu(temb @ params["t1"]["w"] + params["t1"]["b"])
    temb = temb @ params["t2"]["w"] + params["t2"]["b"]

    h0 = layers.conv_apply(params["stem"], x, policy, padding=1, site="stem")
    d1 = _resblock_apply(params["down1"], h0, temb, policy, "down1")
    d2 = _resblock_apply(params["down2"], _down(d1), temb, policy, "down2")
    d3 = _resblock_apply(params["down3"], _down(d2), temb, policy, "down3")
    m = _resblock_apply(params["mid1"], d3, temb, policy, "mid1")
    m = _resblock_apply(params["mid2"], m, temb, policy, "mid2")
    u3 = _resblock_apply(params["up3"], torch.cat([m, d3], 1), temb, policy, "up3")
    u2 = _resblock_apply(params["up2"], torch.cat([_up(u3), d2], 1), temb, policy, "up2")
    u1 = _resblock_apply(params["up1"], torch.cat([_up(u2), d1], 1), temb, policy, "up1")
    return layers.conv_apply(params["out"], F.silu(_gn(u1)), policy, padding=1, site="out")


def draw_t_noise(gen: torch.Generator, x0: torch.Tensor, timesteps: int):
    """``(t, noise)`` for :func:`loss_fn`: uniform timesteps [B] and
    standard normal noise shaped like ``x0``, from ``gen`` (on its
    device)."""
    t = torch.randint(0, timesteps, (x0.shape[0],), generator=gen, device=gen.device)
    noise = torch.randn(x0.shape, generator=gen, device=gen.device)
    return t.to(x0.device), noise.to(x0.device)


def loss_fn(params, sched, x0, t, noise, policy: PolicyLike = DENSE):
    """Epsilon-prediction MSE at the timesteps ``t`` under ``noise``."""
    xt = q_sample(sched, x0, t, noise)
    pred = forward(params, xt, t, policy)
    return torch.mean((pred - noise) ** 2)


def denoise_step(params, sched, x, t, z, policy: PolicyLike = DENSE) -> torch.Tensor:
    """One ancestral step: ``x_{t-1}`` of ``x`` (``x_t``) at the timestep
    ``t``, a 0-d integer tensor on ``x``'s device (so that one captured
    step serves every timestep), under the fresh noise ``z`` (zeros at
    ``t = 0``)."""
    ti = t.long().reshape(1)  # a 0-d tensor index would be read back to the host
    eps = forward(params, x, ti.expand(x.shape[0]), policy)
    alpha = sched["alphas"][ti]
    acp = sched["acp"][ti]
    coef = (1 - alpha) / torch.sqrt(1 - acp)
    mean = (x - coef * eps) / torch.sqrt(alpha)
    return mean + torch.sqrt(sched["betas"][ti]) * z


def sample(
    params,
    sched,
    x_t: torch.Tensor,
    noise: Callable[[int], torch.Tensor],
    policy: PolicyLike = DENSE,
    *,
    step: Callable | None = None,
) -> torch.Tensor:
    """Ancestral sampling from ``x_T`` (``x_t``) to ``x_0``. At loop step
    ``i`` (timestep ``T-1-i``) the fresh noise is ``noise(i)``, shaped
    like ``x_t``, drawn here in loop order; the last step adds zeros.

    Every step is ``step(x, t, z)``, by default :func:`denoise_step`, the
    twin of the reference's ``fori_loop`` body, with the timestep a 0-d
    tensor on ``x_t``'s device (a caller may pass the same step captured
    as a graph, ``launch/train_ddpm.py::sample_images``)."""
    if step is None:
        step = lambda x, t, z: denoise_step(params, sched, x, t, z, policy)  # noqa: E731
    timesteps = sched["betas"].shape[0]
    ts = torch.arange(timesteps - 1, -1, -1, device=x_t.device)
    x = x_t
    with torch.no_grad():
        for i in range(timesteps):
            z = noise(i) if i < timesteps - 1 else torch.zeros_like(x)
            x = step(x, ts[i], z)
    return x


# ----------------------------------------------------------------------
# geometry, FLOPs and routes
# ----------------------------------------------------------------------


def iter_conv_shapes(image, base: int = 64):
    """Yield ``(site, c_in, c_out, k, h_out, w_out)`` for every conv of
    the UNet on ``image`` (C, H, W), in forward order."""
    c, hh, ww = image
    c1, c2, c3 = _widths(base)
    yield ("stem", c, c1, 3, hh, ww)
    for blk, (ci, co, h) in zip(
        ("down1", "down2", "down3"),
        [(c1, c1, hh), (c1, c2, hh // 2), (c2, c3, hh // 4)],
        strict=True,
    ):
        yield (f"{blk}/conv1", ci, co, 3, h, h)
        yield (f"{blk}/conv2", co, co, 3, h, h)
        if ci != co:
            yield (f"{blk}/skip", ci, co, 1, h, h)
    for blk in ("mid1", "mid2"):
        yield (f"{blk}/conv1", c3, c3, 3, hh // 4, hh // 4)
        yield (f"{blk}/conv2", c3, c3, 3, hh // 4, hh // 4)
    for blk, (ci, co, h) in zip(
        ("up3", "up2", "up1"),
        [(c3 + c3, c2, hh // 4), (c2 + c2, c1, hh // 2), (c1 + c1, c1, hh)],
        strict=True,
    ):
        yield (f"{blk}/conv1", ci, co, 3, h, h)
        yield (f"{blk}/conv2", co, co, 3, h, h)
        yield (f"{blk}/skip", ci, co, 1, h, h)
    yield ("out", c1, c, 3, hh, ww)


def flops_per_iter(
    batch: int, image, base: int = 64, drop_rate: float = 0.0, policy: PolicyLike | None = None
) -> tuple[int, int]:
    """``(dense, ssprop)`` backward FLOPs of one iteration (Eq. 6) over
    the UNet's convs. The ssProp count is the nominal Eq. 9 at
    ``drop_rate``; with ``policy`` (a plain policy or a
    :class:`~repro_torch.core.policy.SitePolicies` table over
    :func:`site_names`) it counts each conv at its own site's real keep
    count (block rounding, the kernel route's tile padding)."""
    dense = sparse = 0
    for site, c_in, c_out, k, h, w in iter_conv_shapes(image, base):
        dense += FL.conv_backward_flops(batch, h, w, c_in, c_out, k)
        if policy is not None:
            sparse += FL.conv_backward_flops_site(batch, h, w, c_in, c_out, k, policy, site)
        else:
            sparse += FL.conv_backward_flops_ssprop(batch, h, w, c_in, c_out, k, drop_rate)
    return dense, sparse


def backward_routes(batch: int, image, policy: PolicyLike, base: int = 64) -> dict[str, str]:
    """Site -> the backward route its conv takes under ``policy``
    (:func:`repro_torch.core.conv.backward_route`)."""
    return {
        site: backward_route(
            policy_for(policy, site), batch=batch, h_out=h_out, w_out=w_out, c_in=c_in,
            c_out=c_out, kh=k, kw=k,
        )
        for site, c_in, c_out, k, h_out, w_out in iter_conv_shapes(image, base)
    }


def kernel_launches_per_step(
    batch: int, image, policy: PolicyLike, base: int = 64
) -> dict[str, int]:
    """Launches of each gathered kernel in one training step under
    ``policy`` (:func:`repro_torch.core.conv.route_launches` of
    :func:`backward_routes`); the stem's input, the noisy image, needs no
    gradient."""
    return route_launches(backward_routes(batch, image, policy, base), policy)
