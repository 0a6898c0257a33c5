"""ResNet-18/26/50 (He et al. 2016) with ssProp convolutions.

The twin of ``repro.models.resnet``: functional, dict params, NCHW.
Every convolution goes through :func:`repro_torch.models.layers.conv_apply`
and so through the channel-sparse backward engine. BatchNorm runs on
batch statistics with the biased variance; the statistics it computes
are discarded, as in the JAX package.

Beside the model: :func:`flops_per_iter`, the paper's backward-FLOPs
walk; :func:`backward_routes` and :func:`kernel_launches_per_step`,
which say which backward route each conv takes under a policy, and so
how many times a training step launches each gathered kernel.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import flops as FL
from repro_torch.core import prng
from repro_torch.core.conv import backward_route, route_launches
from repro_torch.core.policy import DENSE, PolicyLike, SsPropPolicy
from repro_torch.models import layers

LAYOUTS = {
    # name: (block_kind, stage_sizes)
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet26": ("basic", (2, 3, 5, 2)),  # paper Table 7 control
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
}
WIDTHS = (64, 128, 256, 512)


def bn_init(c, device):
    kw = dict(dtype=torch.float32, device=device)
    return {
        "scale": torch.ones((c,), **kw),
        "bias": torch.zeros((c,), **kw),
        "mean": torch.zeros((c,), **kw),
        "var": torch.ones((c,), **kw),
    }


def bn_apply(p, x, train: bool = True, momentum: float = 0.9):
    """BatchNorm (NCHW) with the biased batch variance and
    ``rsqrt(var + 1e-5)``. Returns (y, updated_stats)."""
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        new_stats = {
            "mean": momentum * p["mean"] + (1 - momentum) * mean,
            "var": momentum * p["var"] + (1 - momentum) * var,
        }
    else:
        mean, var = p["mean"], p["var"]
        new_stats = {"mean": p["mean"], "var": p["var"]}
    inv = torch.rsqrt(var + 1e-5)
    y = (x - mean[None, :, None, None]) * inv[None, :, None, None]
    return y * p["scale"][None, :, None, None] + p["bias"][None, :, None, None], new_stats


def _basic_block_init(gen, c_in, c_out, stride, device):
    p = {
        "conv1": layers.conv2d_init(gen, c_out, c_in, 3, device=device),
        "bn1": bn_init(c_out, device),
        "conv2": layers.conv2d_init(gen, c_out, c_out, 3, device=device),
        "bn2": bn_init(c_out, device),
    }
    if stride != 1 or c_in != c_out:
        p["down_conv"] = layers.conv2d_init(gen, c_out, c_in, 1, device=device)
        p["down_bn"] = bn_init(c_out, device)
    return p


def _bottleneck_init(gen, c_in, c_mid, stride, device):
    c_out = c_mid * 4
    p = {
        "conv1": layers.conv2d_init(gen, c_mid, c_in, 1, device=device),
        "bn1": bn_init(c_mid, device),
        "conv2": layers.conv2d_init(gen, c_mid, c_mid, 3, device=device),
        "bn2": bn_init(c_mid, device),
        "conv3": layers.conv2d_init(gen, c_out, c_mid, 1, device=device),
        "bn3": bn_init(c_out, device),
    }
    if stride != 1 or c_in != c_out:
        p["down_conv"] = layers.conv2d_init(gen, c_out, c_in, 1, device=device)
        p["down_bn"] = bn_init(c_out, device)
    return p


def init_params(
    name: str,
    seed: int,
    num_classes: int = 10,
    in_channels: int = 3,
    small_stem: bool = True,
    device="cuda",
) -> dict[str, Any]:
    """Random params with the JAX package's distributions (Kaiming-normal
    convs and head, unit BatchNorm), drawn from a ``torch.Generator``
    seeded with ``seed`` on ``device``. small_stem: 3x3/s1 stem for
    CIFAR-scale inputs; 7x7/s2 for ImageNet."""
    kind, stages = LAYOUTS[name]
    gen = torch.Generator(device=device).manual_seed(seed)
    p: dict[str, Any] = {
        "stem": layers.conv2d_init(gen, 64, in_channels, 3 if small_stem else 7, device=device),
        "stem_bn": bn_init(64, device),
        "blocks": [],
    }
    c_in = 64
    for si, (n, w) in enumerate(zip(stages, WIDTHS, strict=True)):
        for b in range(n):
            stride = 2 if (b == 0 and si > 0) else 1
            if kind == "basic":
                p["blocks"].append(_basic_block_init(gen, c_in, w, stride, device))
                c_in = w
            else:
                p["blocks"].append(_bottleneck_init(gen, c_in, w, stride, device))
                c_in = w * 4
    head = torch.randn((c_in, num_classes), generator=gen, dtype=torch.float32, device=device)
    p["head"] = {
        "w": head * math.sqrt(2.0 / c_in),
        "b": torch.zeros((num_classes,), dtype=torch.float32, device=device),
    }
    return p


def params_from_jax(name: str, tree, device="cuda") -> dict[str, Any]:
    """The port's params from a JAX ResNet param tree whose leaves are
    numpy arrays (``jax.tree.map(np.asarray, params)``): the same nested
    dicts and block list, leaf for leaf."""
    _, stages = LAYOUTS[name]
    if len(tree["blocks"]) != sum(stages):
        raise ValueError(f"{name} has {sum(stages)} blocks, the tree {len(tree['blocks'])}")

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v) for v in node]
        return torch.from_numpy(np.array(node, dtype=np.float32)).to(device)

    return convert(tree)


def block_strides(name: str) -> list[int]:
    """Static stride list matching init_params' block order."""
    _, stages = LAYOUTS[name]
    return [2 if (b == 0 and si > 0) else 1 for si, n in enumerate(stages) for b in range(n)]


def site_names(name: str):
    """``(sites, depth)``: this ResNet's conv site names and its number of
    residual blocks."""
    kind, stages = LAYOUTS[name]
    sites = ["stem"]
    c_in, bi = 64, 0
    for si, (n, w) in enumerate(zip(stages, WIDTHS, strict=True)):
        for b in range(n):
            stride = 2 if (b == 0 and si > 0) else 1
            convs = ("conv1", "conv2") if kind == "basic" else ("conv1", "conv2", "conv3")
            sites.extend(f"block_{bi}/{c}" for c in convs)
            c_out = w if kind == "basic" else w * 4
            if stride != 1 or c_in != c_out:
                sites.append(f"block_{bi}/down")
            c_in = c_out
            bi += 1
    return tuple(sites), bi


def _conv(p, x, stride, padding, policy, site, key=None):
    return layers.conv_apply(p, x, policy, stride=stride, padding=padding, key=key, site=site)


def _basic_apply(p, x, stride, policy, train, prefix):
    h, _ = bn_apply(p["bn1"], _conv(p["conv1"], x, stride, 1, policy, f"{prefix}/conv1"), train)
    h = F.relu(h)
    h, _ = bn_apply(p["bn2"], _conv(p["conv2"], h, 1, 1, policy, f"{prefix}/conv2"), train)
    if "down_conv" in p:
        x, _ = bn_apply(
            p["down_bn"], _conv(p["down_conv"], x, stride, 0, policy, f"{prefix}/down"), train
        )
    return F.relu(h + x)


def _bottleneck_apply(p, x, stride, policy, train, prefix):
    h, _ = bn_apply(p["bn1"], _conv(p["conv1"], x, 1, 0, policy, f"{prefix}/conv1"), train)
    h = F.relu(h)
    h, _ = bn_apply(p["bn2"], _conv(p["conv2"], h, stride, 1, policy, f"{prefix}/conv2"), train)
    h = F.relu(h)
    h, _ = bn_apply(p["bn3"], _conv(p["conv3"], h, 1, 0, policy, f"{prefix}/conv3"), train)
    if "down_conv" in p:
        x, _ = bn_apply(
            p["down_bn"], _conv(p["down_conv"], x, stride, 0, policy, f"{prefix}/down"), train
        )
    return F.relu(h + x)


def _max_pool_same(h):
    """3x3/2 max-pool with "SAME" padding at -inf (on an even size: 0
    low and 1 high), as the JAX package's ``reduce_window``."""
    pads = []
    for n in (h.shape[3], h.shape[2]):  # F.pad order: last axis first
        total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
        pads += [total // 2, total - total // 2]
    return F.max_pool2d(F.pad(h, pads, value=-math.inf), kernel_size=3, stride=2)


def forward(
    name: str,
    params,
    x: torch.Tensor,
    policy: SsPropPolicy = DENSE,
    *,
    train: bool = True,
    small_stem: bool = True,
    dropout_rate: float = 0.0,
    dropout_key: torch.Tensor | None = None,
) -> torch.Tensor:
    """x [B, C, H, W] -> logits [B, num_classes]. Dropout after each
    block draws as the JAX package does, from ``dropout_key`` (``[2]``
    int64 JAX key data): ``dk, sub = split(dk)``, then ``bernoulli(sub,
    1 - rate, h.shape)`` (:mod:`repro_torch.core.prng`), so a key gives
    the JAX package's masks bit for bit."""
    kind, _ = LAYOUTS[name]
    stem_stride = 1 if small_stem else 2
    stem_pad = 1 if small_stem else 3
    h, _ = bn_apply(
        params["stem_bn"], _conv(params["stem"], x, stem_stride, stem_pad, policy, "stem"), train
    )
    h = F.relu(h)
    if not small_stem:
        h = _max_pool_same(h)
    dk = dropout_key
    for bi, (blk, stride) in enumerate(zip(params["blocks"], block_strides(name), strict=True)):
        apply = _basic_apply if kind == "basic" else _bottleneck_apply
        h = apply(blk, h, stride, policy, train, f"block_{bi}")
        if dropout_rate > 0.0 and train:
            if dk is None:
                raise ValueError("dropout needs a dropout_key")
            dk, sub = prng.split(dk.to(h.device))
            keep = prng.bernoulli(sub, 1.0 - dropout_rate, h.shape)
            h = h * keep.to(h.dtype) / (1.0 - dropout_rate)
    h = h.mean(dim=(2, 3))
    return h @ params["head"]["w"] + params["head"]["b"]


def iter_conv_shapes(name: str, image: tuple[int, int, int]):
    """Yield ``(site, c_in, c_out, k, h_out, w_out)`` for every conv of
    this ResNet on ``image`` (C, H, W)."""
    kind, stages = LAYOUTS[name]
    c, hh, ww = image
    small = hh <= 64
    if small:
        yield ("stem", c, 64, 3, hh, ww)
        h_cur, w_cur = hh, ww
    else:
        yield ("stem", c, 64, 7, hh // 2, ww // 2)
        h_cur, w_cur = hh // 4, ww // 4  # stem stride + maxpool
    c_in = 64
    bi = 0
    for si, (n, w) in enumerate(zip(stages, WIDTHS, strict=True)):
        for b in range(n):
            stride = 2 if (b == 0 and si > 0) else 1
            h_cur2, w_cur2 = h_cur // stride, w_cur // stride
            if kind == "basic":
                yield (f"block_{bi}/conv1", c_in, w, 3, h_cur2, w_cur2)
                yield (f"block_{bi}/conv2", w, w, 3, h_cur2, w_cur2)
                if stride != 1 or c_in != w:
                    yield (f"block_{bi}/down", c_in, w, 1, h_cur2, w_cur2)
                c_out = w
            else:
                yield (f"block_{bi}/conv1", c_in, w, 1, h_cur, w_cur)
                yield (f"block_{bi}/conv2", w, w, 3, h_cur2, w_cur2)
                yield (f"block_{bi}/conv3", w, w * 4, 1, h_cur2, w_cur2)
                if stride != 1 or c_in != w * 4:
                    yield (f"block_{bi}/down", c_in, w * 4, 1, h_cur2, w_cur2)
                c_out = w * 4
            c_in = c_out
            h_cur, w_cur = h_cur2, w_cur2
            bi += 1


def flops_per_iter(
    name: str,
    batch: int,
    image: tuple[int, int, int],
    drop_rate: float = 0.0,
    policy: PolicyLike | None = None,
) -> tuple[int, int]:
    """``(dense, ssprop)`` backward FLOPs of one iteration from the
    paper's Eq. 6/7 model, over :func:`iter_conv_shapes` (each conv and
    the BatchNorm after it). The ssProp count is the nominal Eq. 9 at
    ``drop_rate``; with ``policy`` (a plain policy or a
    :class:`~repro_torch.core.policy.SitePolicies` table over
    :func:`site_names`) it counts each conv at its own site's real keep
    count instead."""
    dense = sparse = 0
    for site, c_in, c_out, k, h_out, w_out in iter_conv_shapes(name, image):
        dense += FL.conv_backward_flops(batch, h_out, w_out, c_in, c_out, k)
        if policy is not None:
            sparse += FL.conv_backward_flops_site(
                batch, h_out, w_out, c_in, c_out, k, policy, site
            )
        else:
            sparse += FL.conv_backward_flops_ssprop(
                batch, h_out, w_out, c_in, c_out, k, drop_rate
            )
        bn = FL.batchnorm_backward_flops(batch, h_out, w_out, c_out)
        dense += bn
        sparse += bn
    return dense, sparse


def backward_routes(
    name: str, batch: int, image: tuple[int, int, int], policy: SsPropPolicy
) -> dict[str, str]:
    """Site -> the backward route its conv takes under ``policy``
    (:func:`repro_torch.core.conv.backward_route`)."""
    return {
        site: backward_route(
            policy, batch=batch, h_out=h_out, w_out=w_out, c_in=c_in, c_out=c_out, kh=k, kw=k
        )
        for site, c_in, c_out, k, h_out, w_out in iter_conv_shapes(name, image)
    }


def kernel_launches_per_step(
    name: str, batch: int, image: tuple[int, int, int], policy: SsPropPolicy
) -> dict[str, int]:
    """Launches of each gathered kernel in one training step under
    ``policy`` (:func:`repro_torch.core.conv.route_launches` of
    :func:`backward_routes`); the stem's input, the image, needs no
    gradient."""
    return route_launches(backward_routes(name, batch, image, policy), policy)
