"""The port's ssProp training path against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages; on
the CPU the port's gathered kernels run their plain versions and the
JAX package's run their Pallas kernels in interpret mode. Covered: the
policy, schedule, traffic-model and data copies; the route table of
ResNet-18 at the paper's shape; ResNet-18's loss and gradients and three
Adam steps; ResNet-50's forward with the ImageNet stem; Adam; the
training CLI. The backward engine's grid is in
``tests/test_torch_backward.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flops as jflops
from repro.core import policy as jpolicy
from repro.core import schedulers as jsched
from repro.data import pipeline as jpipe
from repro.models import resnet as jresnet
from repro.optim import adam as jadam
from repro_torch.core import flops as tflops
from repro_torch.core import prng as tprng
from repro_torch.core import policy as tpolicy
from repro_torch.core import schedulers as tsched
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train_classifier as tc
from repro_torch.models import resnet as tresnet
from repro_torch.optim import adam as tadam


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    n = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / n) if n > 0 else float(np.linalg.norm(a))


# --- host-side copies -------------------------------------------------


def test_policy_twin():
    fields = lambda c: [(f.name, f.default) for f in dataclasses.fields(c)]  # noqa: E731
    assert fields(tpolicy.SsPropPolicy) == fields(jpolicy.SsPropPolicy)
    for make in ("paper_default", "tpu_default"):
        for rate in (0.0, 0.5, 0.8):
            assert dataclasses.asdict(getattr(tpolicy, make)(rate)) == dataclasses.asdict(
                getattr(jpolicy, make)(rate))
    assert dataclasses.asdict(tpolicy.DENSE) == dataclasses.asdict(jpolicy.DENSE)
    for gran in ("channel", "block"):
        for bs in (4, 32, 128):
            for rate in (0.0, 0.25, 0.5, 0.8, 0.95):
                tp = tpolicy.SsPropPolicy(rate, granularity=gran, block_size=bs)
                jp = jpolicy.SsPropPolicy(rate, granularity=gran, block_size=bs)
                for c in (1, 3, 10, 64, 130, 512):
                    assert tp.keep_count(c) == jp.keep_count(c)
                assert tp.bucketed(0.7) == tpolicy.SsPropPolicy(**dataclasses.asdict(
                    jp.bucketed(0.7)))
    for bad in (dict(drop_rate=1.0), dict(granularity="row"), dict(selection="x"),
                dict(scheduler="epochbar")):
        with pytest.raises(ValueError):
            tpolicy.SsPropPolicy(**bad)
    with pytest.raises(TypeError, match="neither SsPropPolicy nor SitePolicies"):
        tpolicy.policy_for(jpolicy.SitePolicies(()), "stem")  # the JAX package's table


@pytest.mark.parametrize("name", sorted(jsched.SCHEDULES))
def test_schedules_match(name):
    kw = dict(steps_per_epoch=3, target=0.8, period=7)
    for total in (1, 6, 12, 13):
        for step in range(total + 2):
            assert tsched.drop_rate_for_step(name, step=step, total_steps=total, **kw) == \
                jsched.drop_rate_for_step(name, step=step, total_steps=total, **kw)
        assert tsched.average_rate(name, total_steps=total, **kw) == \
            jsched.average_rate(name, total_steps=total, **kw)
        ts = tsched.make_schedule(name, target=0.8, total_steps=total, steps_per_epoch=3)
        js = jsched.make_schedule(name, target=0.8, total_steps=total, steps_per_epoch=3)
        assert [ts.scale(s) for s in range(total)] == [js.scale(s) for s in range(total)]


def test_traffic_model_matches():
    pol = dataclasses.replace(jpolicy.tpu_default(0.8), use_pallas=True)
    tpol = dataclasses.replace(tpolicy.tpu_default(0.8), use_pallas=True)
    for args in [(128, 32, 32, 3, 64, 3), (128, 16, 16, 64, 128, 1), (8, 8, 8, 256, 256, 3),
                 (4, 7, 7, 12, 24, 3)]:
        for fused in (None, True, False):
            for groups in (1, 2, 4):
                assert tflops.conv_backward_bytes_policy(
                    *args, tpol, fused=fused, groups=groups
                ) == jflops.conv_backward_bytes_policy(*args, pol, fused=fused, groups=groups)
        assert tflops.conv_backward_bytes_breakdown(*args, tpol, fused=True) == \
            jflops.conv_backward_bytes_breakdown(*args, pol, fused=True)
        assert tflops.kept_channels(args[4], tpol) == jflops.kept_channels(args[4], pol)


def test_image_pipeline_identical():
    cfg = ((3, 8, 8), 10, 6)
    tp = tpipe.ImagePipeline(tpipe.ImagePipelineConfig(*cfg, seed=11), n_train=64)
    jp = jpipe.ImagePipeline(jpipe.ImagePipelineConfig(*cfg, seed=11), n_train=64)
    for step in (0, 1, 17):
        a, b = tp.batch_at(step), jp.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    a, b = tp.eval_batch(32), jp.eval_batch(32)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


# --- ResNet -----------------------------------------------------------

SSPROP_BLOCK_PALLAS = dict(use_pallas=True)  # benchmarks/roofline.py:251-253


def test_route_table_matches_jax_gate():
    """ResNet-18 at the paper's Table 4 shape (B=128, 3x32x32) under
    ``tpu_default(0.8)`` with ``use_pallas``: the port routes every conv
    as the JAX package's gate does (``core/conv.py:159-184`` there:
    fused iff fuse_im2col, not 1x1, and the traffic model's fused bytes
    below the materialized ones; else the canonical im2col). The launch
    counts chip_smoke.py asserts come from this table."""
    jpol = dataclasses.replace(jpolicy.tpu_default(0.8), **SSPROP_BLOCK_PALLAS)
    tpol = dataclasses.replace(tpolicy.tpu_default(0.8), **SSPROP_BLOCK_PALLAS)
    routes = tresnet.backward_routes("resnet18", 128, (3, 32, 32), tpol)
    for site, c_in, c_out, k, h_out, w_out in jresnet.iter_conv_shapes("resnet18", (3, 32, 32)):
        model = lambda fused: jflops.conv_backward_bytes_policy(  # noqa: E731
            128, h_out, w_out, c_in, c_out, k, jpol, fused=fused)
        fused = k > 1 and model(True) < model(False)
        assert routes[site] == ("fused" if fused else "canonical"), site
    assert list(routes) == list(jresnet.site_names("resnet18")[0])
    fused = [s for s, r in routes.items() if r == "fused"]
    # every 3x3 conv of the 8 blocks fuses (16); the stem (C_in=3) and the
    # three 1x1 down convs take the canonical im2col route
    assert len(fused) == 16 and "stem" not in fused
    assert tresnet.kernel_launches_per_step("resnet18", 128, (3, 32, 32), tpol) == {
        "dx_gathered": 3, "dw_gathered": 4, "conv_dw_fused": 16, "conv_dx_fused": 16,
    }
    dense = tpolicy.SsPropPolicy(0.0)
    assert set(tresnet.backward_routes("resnet18", 128, (3, 32, 32), dense).values()) == {"full"}
    assert sum(tresnet.kernel_launches_per_step("resnet18", 128, (3, 32, 32), dense).values()) == 0


def _resnet_pair(name, seed=0, **kw):
    pj = jresnet.init_params(name, jax.random.PRNGKey(seed), num_classes=10, **kw)
    return pj, tresnet.params_from_jax(name, jax.tree.map(np.asarray, pj), device="cpu")


def _loss_j(name, pol):
    def loss(p, x, y):
        logits = jresnet.forward(name, p, x, pol)
        return -jax.nn.log_softmax(logits)[jnp.arange(x.shape[0]), y].mean()
    return loss


def test_resnet18_loss_grads_and_adam_steps_match_jax():
    """ResNet-18 at block size 32 (so the 64- and 128-wide stages drop
    blocks too), B=4, 3x16x16, params converted by ``params_from_jax``:
    the loss and every gradient leaf of one sparse step on the kernel
    route match the JAX package's Pallas route (interpret mode) at
    relative L2 <= 1e-4; then three Adam steps (dense, sparse, sparse)
    give the same losses at 1e-4."""
    name = "resnet18"
    pj, pt = _resnet_pair(name)
    kw = dict(block_size=32, use_pallas=True)
    jpol = dataclasses.replace(jpolicy.tpu_default(0.8), **kw)
    tpol = dataclasses.replace(tpolicy.tpu_default(0.8), **kw)
    vag = {
        True: jax.jit(jax.value_and_grad(_loss_j(name, jpol))),
        False: jax.jit(jax.value_and_grad(_loss_j(name, jpolicy.SsPropPolicy(0.0)))),
    }
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 3, 16, 16)).astype(np.float32)
    y = rng.integers(0, 10, 4).astype(np.int32)
    lj, gj = vag[True](pj, jnp.asarray(x), jnp.asarray(y))
    lt, gt = tc.value_and_grad(name, pt, torch.from_numpy(x), torch.from_numpy(y).long(), tpol)
    assert abs(float(lt) - float(lj)) <= 1e-4 * abs(float(lj))
    leaves_j, leaves_t = jax.tree.leaves(gj), tadam.tree_leaves(gt)
    assert len(leaves_j) == len(leaves_t)
    for a, b in zip(leaves_t, leaves_j, strict=True):
        assert tuple(a.shape) == b.shape
        assert _rel(a.numpy(), b) <= 1e-4

    # three Adam steps: dense, sparse, sparse
    ocfg_j, ocfg_t = jadam.AdamConfig(lr=1e-3), tadam.AdamConfig(lr=1e-3)
    adam_j = jax.jit(lambda p, g, o: jadam.apply_updates(ocfg_j, p, g, o)[:2])
    oj, ot = jadam.init(pj), tadam.init(pt)
    pipe = jpipe.ImagePipeline(jpipe.ImagePipelineConfig((3, 16, 16), 10, 4, seed=1), n_train=64)
    for i, sparse in enumerate((False, True, True)):
        bt = pipe.batch_at(i)
        lj, gj = vag[sparse](pj, jnp.asarray(bt["images"]), jnp.asarray(bt["labels"]))
        pj, oj = adam_j(pj, gj, oj)
        pol_t = tpol if sparse else tpolicy.SsPropPolicy(0.0)
        pt, ot, lt = tc.train_step(name, pt, ot, torch.from_numpy(bt["images"]),
                                   torch.from_numpy(bt["labels"]).long(), pol_t, ocfg_t)
        assert abs(float(lt) - float(lj)) <= 1e-4 * abs(float(lj)), (i, float(lt), float(lj))


def test_resnet50_imagenet_stem_forward_matches_jax():
    """ResNet-50 (bottlenecks) with the 7x7/2 stem and the "SAME" max-pool,
    B=2: the logits match the JAX package's. The image is 3x64x64: at
    3x16x16 the last two stages are 1x1, and BatchNorm over two values
    is a sign function that summation order flips."""
    pj, pt = _resnet_pair("resnet50", small_stem=False)
    x = np.random.default_rng(2).standard_normal((2, 3, 64, 64)).astype(np.float32)
    lj = jax.jit(lambda p, x: jresnet.forward("resnet50", p, x, small_stem=False))(
        pj, jnp.asarray(x))
    with torch.no_grad():
        lt = tresnet.forward("resnet50", pt, torch.from_numpy(x), small_stem=False)
    assert _rel(lt.numpy(), lj) <= 1e-4


def test_resnet_init_and_tables():
    p = tresnet.init_params("resnet18", 0, device="cpu")
    pj = jresnet.init_params("resnet18", jax.random.PRNGKey(0))
    shapes = lambda t: [tuple(np.shape(v)) for v in t]  # noqa: E731
    assert shapes(tadam.tree_leaves(p)) == shapes(jax.tree.leaves(pj))
    w = p["blocks"][3]["conv2"]["w"]
    assert abs(float(w.std()) - np.sqrt(2.0 / (128 * 9))) < 0.05 * np.sqrt(2.0 / (128 * 9))
    assert torch.equal(p["stem"]["w"], tresnet.init_params("resnet18", 0, device="cpu")["stem"]["w"])
    for name in tresnet.LAYOUTS:
        assert tresnet.site_names(name) == jresnet.site_names(name)
        assert tresnet.block_strides(name) == jresnet.block_strides(name)
        for image in ((3, 32, 32), (3, 224, 224)):
            assert list(tresnet.iter_conv_shapes(name, image)) == list(
                jresnet.iter_conv_shapes(name, image))


def test_dropout_properties():
    _, pt = _resnet_pair("resnet18")
    x = torch.randn(2, 3, 8, 8)
    run = lambda s: tresnet.forward(  # noqa: E731
        "resnet18", pt, x, dropout_rate=0.5, dropout_key=tprng.key(s))
    with torch.no_grad():
        a, b, c = run(0), run(0), run(1)
        plain = tresnet.forward("resnet18", pt, x)
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, plain)
    with pytest.raises(ValueError, match="dropout"):
        tresnet.forward("resnet18", pt, x, dropout_rate=0.5)


# --- Adam -------------------------------------------------------------


@pytest.mark.parametrize("cfg", [
    dict(weight_decay=1e-2),
    dict(clip_norm=0.5),
    dict(schedule="warmup_cosine", warmup_steps=2, total_steps=5, clip_norm=1.0),
    dict(schedule="cosine", total_steps=4),
])
def test_adam_matches_jax(cfg):
    rng = np.random.default_rng(5)
    tree = {"a": rng.standard_normal((3, 4)), "b": [rng.standard_normal((5,)),
            {"c": rng.standard_normal((2, 2))}]}
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    pj = jax.tree.map(jnp.asarray, tree)
    pt = tadam.tree_map(torch.from_numpy, tree)
    oj, ot = jadam.init(pj), tadam.init(pt)
    cj, ct = jadam.AdamConfig(lr=1e-2, **cfg), tadam.AdamConfig(lr=1e-2, **cfg)
    for step in range(4):
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * (step + 1)).astype(np.float32),
                         tree)
        pj, oj, mj = jadam.apply_updates(cj, pj, jax.tree.map(jnp.asarray, g), oj)
        pt, ot, mt = tadam.apply_updates(ct, pt, tadam.tree_map(torch.from_numpy, g), ot)
        np.testing.assert_allclose(float(mt["grad_norm"]), float(mj["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(mt["lr"]), float(mj["lr"]), rtol=1e-6)
        for a, b in zip(tadam.tree_leaves((pt, ot.m, ot.v)), jax.tree.leaves((pj, oj.m, oj.v)),
                        strict=True):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)
    assert int(ot.step) == int(oj.step) == 4


# --- the CLI ----------------------------------------------------------


def test_train_cli_on_cpu():
    args = tc.build_parser().parse_args(
        ["--device", "cpu", "--batch", "4", "--image-size", "8", "--steps", "4",
         "--steps-per-epoch", "1", "--granularity", "block", "--block-size", "32",
         "--use-pallas", "--mode", "both"])
    out = tc.run(args)
    assert set(out["modes"]) == {"dense", "ssprop"}
    for mode, rec in out["modes"].items():
        assert len(rec["losses"]) == len(rec["step_times"]) == 4 and len(rec["eval_acc"]) == 4
        assert np.isfinite(rec["losses"]).all()
        assert rec["rates"] == ([0.0] * 4 if mode == "dense" else [0.0, 0.8, 0.0, 0.8])
    # dense and sparse start from the same init and batches: step 0 agrees
    assert out["modes"]["dense"]["losses"][0] == out["modes"]["ssprop"]["losses"][0]
    assert out["launches"] == dict.fromkeys(out["launches"], 0)  # the CPU runs plain versions
    defaults = tc.build_parser().parse_args([])
    assert (defaults.device, defaults.mode, defaults.granularity, defaults.use_pallas) == \
        ("cuda", "both", "channel", False)
    assert tc.step_policy(defaults, 0.8) == tpolicy.paper_default(0.8)


@pytest.mark.parametrize("before", [True, False])
def test_train_cli_runs_in_fp32_and_restores_the_tf32_flags(before):
    """The run pins TF32 off for matmuls and convolutions (the JAX package
    computes in fp32), says so in its result, and hands the caller's
    flags back; the flags are global in any build, so the CPU shows it."""
    torch.backends.cuda.matmul.allow_tf32 = before
    torch.backends.cudnn.allow_tf32 = before
    try:
        args = tc.build_parser().parse_args(
            ["--device", "cpu", "--batch", "2", "--image-size", "8", "--steps", "1",
             "--steps-per-epoch", "1", "--mode", "dense"])
        out = tc.run(args)
        assert out["tf32"] == {"matmul": False, "cudnn": False}
        assert torch.backends.cuda.matmul.allow_tf32 is before
        assert torch.backends.cudnn.allow_tf32 is before
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True


def test_train_cli_wants_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda is allowed")
    args = tc.build_parser().parse_args(["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tc.run(args)
