"""The port's DDPM (the paper's generation task) against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages; the
JAX params are converted through ``ddpm.params_from_jax``. On the CPU
the port's gathered kernels run their plain versions and the JAX
package's run their Pallas kernels in interpret mode. ``jax.random``
cannot be matched, so the timesteps and noise of the loss, and the
sampling noise stream, are drawn once (the latter by re-splitting the
JAX key as ``ddpm.sample`` does) and handed to both.

Covered: the diffusion functions, GroupNorm, the pooling pair, the site
and shape tables; the loss and every gradient leaf on the dense, gather
(channel), kernel (block 4 + ``use_pallas``) and mask routes; three
AdamW steps; ``sample``; the route table against the JAX gate at block
sizes 4 and 32; the ``train_ddpm`` CLI on the CPU.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flops as jflops
from repro.core import policy as jpolicy
from repro.models import ddpm as jddpm
from repro.optim import adam as jadam
from repro_torch.core import backward as tbackward
from repro_torch.core import policy as tpolicy
from repro_torch.launch import train_ddpm as td
from repro_torch.models import ddpm as tddpm
from repro_torch.optim import adam as tadam

IMAGE, T = (3, 8, 8), 10


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    n = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / n) if n > 0 else float(np.linalg.norm(a))


def _pair(base, seed=0):
    """Params of the JAX package's tree (its structure from
    ``jax.eval_shape`` of ``init_params``) filled from numpy with a seed:
    filters at the Kaiming scale, linears at ``1/sqrt(d_in)``, biases
    nonzero so that every bias path carries signal; the JAX arrays and the
    port's ``params_from_jax`` of the same numpy values."""
    shapes = jax.eval_shape(
        functools.partial(jddpm.init_params, channels=IMAGE[0], base=base, t_dim=16),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(leaf):
        shape = leaf.shape
        fan_in = np.prod(shape[1:]) if len(shape) == 4 else shape[0]
        scale = 0.1 if len(shape) == 1 else np.sqrt((2.0 if len(shape) == 4 else 1.0) / fan_in)
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    tree = jax.tree.map(fill, shapes)
    return jax.tree.map(jnp.asarray, tree), tddpm.params_from_jax(tree, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch's CPU thread pool and XLA's contend in one process: at these
    tiny shapes one torch thread runs a step in milliseconds, eight in
    seconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the diffusion functions and layers --------------------------------


@pytest.mark.parametrize("timesteps", [5, 10, 200, 1000])
def test_schedule_q_sample_and_time_embedding_match(timesteps):
    sj = jddpm.make_schedule(timesteps)
    st = tddpm.make_schedule(timesteps, device="cpu")
    assert list(st) == list(sj)
    for k in sj:  # an ulp apart at most, which 1 - acp near t=0 magnifies
        assert st[k].dtype == torch.float32
        tol = dict(rtol=0, atol=2e-6) if k == "sqrt_1macp" else dict(rtol=1e-6, atol=0)
        np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]), **tol)
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((4, 3, 5, 5)).astype(np.float32)
    noise = rng.standard_normal((4, 3, 5, 5)).astype(np.float32)
    t = rng.integers(0, timesteps, 4).astype(np.int32)
    np.testing.assert_allclose(
        tddpm.q_sample(st, torch.from_numpy(x0), torch.from_numpy(t), torch.from_numpy(noise)),
        np.asarray(jddpm.q_sample(sj, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))),
        rtol=1e-5, atol=1e-6)
    for dim in (16, 64, 256):  # an ulp of an angle near 1000 rad is 6e-5
        tt = np.arange(0, timesteps, max(1, timesteps // 7)).astype(np.int32)
        np.testing.assert_allclose(
            tddpm.time_embedding(torch.from_numpy(tt), dim).numpy(),
            np.asarray(jddpm.time_embedding(jnp.asarray(tt), dim)), rtol=0, atol=1e-4)


@pytest.mark.parametrize("shape", [(2, 8, 8, 8), (2, 16, 4, 4), (3, 64, 6, 6), (1, 3, 4, 4)])
def test_group_norm_and_pooling_match(shape):
    x = (np.random.default_rng(1).standard_normal(shape) * 3 + 1).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_allclose(tddpm._gn(xt).numpy(), np.asarray(jddpm._gn(xj)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tddpm._down(xt).numpy(), np.asarray(jddpm._down(xj)))
    np.testing.assert_array_equal(tddpm._up(xt).numpy(), np.asarray(jddpm._up(xj)))


def test_sites_shapes_and_init_match():
    for base in (8, 16, 64):
        assert tddpm.site_names(base) == jddpm.site_names(base)
        for image in (IMAGE, (1, 28, 28), (3, 64, 64)):
            assert list(tddpm.iter_conv_shapes(image, base)) == list(
                jddpm.iter_conv_shapes(image, base))
    assert tddpm.BLOCKS == jddpm.BLOCKS
    pt = tddpm.init_params(0, channels=3, base=16, t_dim=64, device="cpu")
    pj = jax.eval_shape(lambda k: jddpm.init_params(k, channels=3, base=16, t_dim=64),
                        jax.random.PRNGKey(0))
    assert jax.tree.structure(pj) == jax.tree.structure(jax.tree.map(lambda t: t.numpy(), pt))
    shapes = lambda t: [tuple(np.shape(v)) for v in t]  # noqa: E731
    assert shapes(tadam.tree_leaves(pt)) == shapes(jax.tree.leaves(pj))
    w = pt["up1"]["conv1"]["w"]
    assert abs(float(w.std()) / np.sqrt(2.0 / (32 * 9)) - 1) < 0.05
    assert not pt["up1"]["conv1"]["b"].any() and not pt["t1"]["b"].any()
    assert torch.equal(w, tddpm.init_params(0, channels=3, base=16, t_dim=64,
                                            device="cpu")["up1"]["conv1"]["w"])


# --- loss and gradients on four routes ----------------------------------

KERNEL_KW = dict(block_size=4, use_pallas=True)
ROUTES = {
    "dense": lambda m: m.SsPropPolicy(0.0),
    "gather": lambda m: m.paper_default(0.8),
    "kernel": lambda m: dataclasses.replace(m.tpu_default(0.8), **KERNEL_KW),
    "mask": lambda m: dataclasses.replace(m.tpu_default(0.8), block_size=4, mask_mode=True),
}
_JIT: dict = {}


def _vag_j(route, sched_j):
    """The JAX side, jitted once per route: q_sample + forward + MSE."""
    if route not in _JIT:
        pol = ROUTES[route](jpolicy)

        def loss(p, x0, t, noise):
            pred = jddpm.forward(p, jddpm.q_sample(sched_j, x0, t, noise), t, pol)
            return jnp.mean((pred - noise) ** 2)

        _JIT[route] = jax.jit(jax.value_and_grad(loss))
    return _JIT[route]


def _batch(rng, b=2):
    x0 = rng.standard_normal((b, *IMAGE)).astype(np.float32)
    t = rng.integers(0, T, b).astype(np.int32)
    noise = rng.standard_normal((b, *IMAGE)).astype(np.float32)
    return x0, t, noise


@pytest.mark.parametrize("route", list(ROUTES))
def test_loss_and_every_grad_match_jax(route):
    """Base 16 (GroupNorm over one channel, as at base 8, would make the
    conv1 and temb biases' gradients zero in exact arithmetic, and a
    relative check of rounding noise), B=2, 3x8x8, T=10: the loss and
    every gradient leaf, biases included, at relative L2 <= 1e-4. On the
    kernel route blocks of 4 drop at 16 and 32 channels (1 of 4, 2 of
    8), the 3-channel head keeps its ragged block, and the selections
    of the kernel and gather-at-block routes agree site for site."""
    pj, pt = _pair(16)
    sj, st = jddpm.make_schedule(T), tddpm.make_schedule(T, device="cpu")
    x0, t, noise = _batch(np.random.default_rng(3))
    lj, gj = _vag_j(route, sj)(pj, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))
    pol = ROUTES[route](tpolicy)
    with tbackward.record_selections() as log:
        lt, gt = td.value_and_grad(pt, st, torch.from_numpy(x0), torch.from_numpy(t).long(),
                                   torch.from_numpy(noise), pol)
    assert abs(float(lt) - float(lj)) <= 1e-4 * abs(float(lj))
    leaves_j, leaves_t = jax.tree.leaves(gj), tadam.tree_leaves(gt)
    assert len(leaves_j) == len(leaves_t) == len(jax.tree.leaves(pj))
    for a, b in zip(leaves_t, leaves_j, strict=True):
        assert tuple(a.shape) == b.shape
        assert _rel(a.numpy(), b) <= 1e-4
    n_sites = len(tddpm.site_names(16)[0])
    assert len(log) == (0 if route == "dense" else n_sites)
    if route == "kernel":  # the same blocks as the plain gather at block 4
        with tbackward.record_selections() as log2:
            td.value_and_grad(pt, st, torch.from_numpy(x0), torch.from_numpy(t).long(),
                              torch.from_numpy(noise), dataclasses.replace(pol, use_pallas=False))
        for (_, a), (_, b) in zip(log, log2, strict=True):
            assert torch.equal(a.block_idx, b.block_idx)
        kept = {s.block_idx.numel() for _, s in log}
        assert kept == {1, 2}  # 1 of 1 (head), 1 of 4 (16 ch.), 2 of 8 (32 ch.)


def test_three_adamw_steps_match_jax():
    """Dense, sparse (kernel route), sparse: the same losses at 1e-4,
    with the paper's AdamW (lr 1e-3, weight decay 1e-2)."""
    pj, pt = _pair(16, seed=1)
    sj, st = jddpm.make_schedule(T), tddpm.make_schedule(T, device="cpu")
    ocfg_j, ocfg_t = jadam.adamw(), tadam.adamw()
    assert dataclasses.asdict(ocfg_t) == dataclasses.asdict(ocfg_j)
    adam_j = jax.jit(lambda p, g, o: jadam.apply_updates(ocfg_j, p, g, o)[:2])
    oj, ot = jadam.init(pj), tadam.init(pt)
    rng = np.random.default_rng(4)
    for i, route in enumerate(("dense", "kernel", "kernel")):
        x0, t, noise = _batch(rng)
        lj, gj = _vag_j(route, sj)(pj, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))
        pj, oj = adam_j(pj, gj, oj)
        pt, ot, lt = td.train_step(pt, ot, st, torch.from_numpy(x0), torch.from_numpy(t).long(),
                                   torch.from_numpy(noise), ROUTES[route](tpolicy), ocfg_t)
        assert abs(float(lt) - float(lj)) <= 1e-4 * abs(float(lj)), (i, float(lt), float(lj))
    for a, b in zip(tadam.tree_leaves(pt), jax.tree.leaves(pj), strict=True):
        assert _rel(a.numpy(), b) <= 1e-4


def test_sample_matches_jax():
    """T=5, base 8, B=2: the port fed x_T and the per-step noise that
    ``jddpm.sample`` draws from PRNGKey(42) gives its samples at 1e-4."""
    pj, pt = _pair(8)
    steps = 5
    sj, st = jddpm.make_schedule(steps), tddpm.make_schedule(steps, device="cpu")
    shape = (2, *IMAGE)
    ref = jddpm.sample(pj, sj, jax.random.PRNGKey(42), shape)
    rng = jax.random.PRNGKey(42)
    x_t = torch.from_numpy(np.array(jax.random.normal(rng, shape)))
    noise = []
    for _ in range(steps):
        rng, kn = jax.random.split(rng)
        noise.append(torch.from_numpy(np.array(jax.random.normal(kn, shape))))
    got = tddpm.sample(pt, st, x_t, lambda i: noise[i])
    assert got.shape == shape and torch.isfinite(got).all()
    assert _rel(got.numpy(), ref) <= 1e-4


# --- the route table ----------------------------------------------------


@pytest.mark.parametrize("bs", [4, 32])
@pytest.mark.parametrize("batch,image,base", [(4, IMAGE, 8), (128, (3, 64, 64), 64)])
def test_backward_routes_match_jax_gate(batch, image, base, bs):
    """Each site's route equals the JAX package's gate (fused iff
    fuse_im2col, not 1x1, and the traffic model's fused bytes below the
    materialized ones; else the canonical im2col), and the launch table
    follows from it. At the paper's CelebA shape and block 32 every 3x3
    conv but the stem fuses."""
    jpol = dataclasses.replace(jpolicy.tpu_default(0.8), block_size=bs, use_pallas=True)
    tpol = dataclasses.replace(tpolicy.tpu_default(0.8), block_size=bs, use_pallas=True)
    routes = tddpm.backward_routes(batch, image, tpol, base)
    assert list(routes) == list(jddpm.site_names(base)[0])
    for site, c_in, c_out, k, h, w in jddpm.iter_conv_shapes(image, base):
        model = lambda fused: jflops.conv_backward_bytes_policy(  # noqa: E731
            batch, h, w, c_in, c_out, k, jpol, fused=fused)
        fused = k > 1 and model(True) < model(False)
        assert routes[site] == ("fused" if fused else "canonical"), site
    n = tddpm.kernel_launches_per_step(batch, image, tpol, base)
    fused = [s for s, r in routes.items() if r == "fused"]
    canon = [s for s, r in routes.items() if r == "canonical"]
    assert n == {"dx_gathered": len([s for s in canon if s != "stem"]), "dw_gathered": len(canon),
                 "conv_dw_fused": len(fused),
                 "conv_dx_fused": len([s for s in fused if s != "stem"])}
    if base == 64 and bs == 32:
        assert canon == ["stem", "down2/skip", "up3/skip", "up2/skip", "up1/skip"]
        assert n == {"dx_gathered": 4, "dw_gathered": 5, "conv_dw_fused": 17,
                     "conv_dx_fused": 17}
    dense = tpolicy.SsPropPolicy(0.0)
    assert set(tddpm.backward_routes(batch, image, dense, base).values()) == {"full"}
    # the gather route is the same policy without use_pallas
    assert set(tddpm.backward_routes(
        batch, image, dataclasses.replace(tpol, use_pallas=False), base).values()) == {"gathered"}


def test_main_path_policy_is_the_cli_policy():
    """``--granularity block --block-size 32 --use-pallas`` gives, at a
    sparse step, ``tpu_default(0.8)`` at block 32 with ``use_pallas``."""
    args = td.build_parser().parse_args(
        ["--granularity", "block", "--block-size", "32", "--use-pallas"])
    assert td.step_policy(args, 0.8) == dataclasses.replace(
        tpolicy.tpu_default(0.8), block_size=32, use_pallas=True)


# --- the CLI --------------------------------------------------------------


def test_train_ddpm_cli_on_cpu():
    args = td.build_parser().parse_args(
        ["--device", "cpu", "--batch", "2", "--size", "8", "--timesteps", "10", "--channels",
         "3", "--base", "8", "--t-dim", "16", "--steps", "4", "--steps-per-epoch", "1",
         "--granularity", "block", "--block-size", "4", "--use-pallas", "--out", ""])
    out = td.run(args)
    assert set(out["modes"]) == {"dense", "ssprop"} and out["sampled_from"] == "ssprop"
    for mode, rec in out["modes"].items():
        assert len(rec["losses"]) == len(rec["step_times"]) == 4
        assert np.isfinite(rec["losses"]).all()
        assert rec["rates"] == ([0.0] * 4 if mode == "dense" else [0.0, 0.8, 0.0, 0.8])
    # dense and sparse start from the same init, batches and noise
    assert out["modes"]["dense"]["losses"][:2] == out["modes"]["ssprop"]["losses"][:2]
    assert out["launches"] == dict.fromkeys(out["launches"], 0)  # the CPU runs plain versions
    assert out["samples"].shape == (4, 3, 8, 8) and np.isfinite(out["samples"]).all()
    assert out["tf32"] == {"matmul": False, "cudnn": False}
    led = out["flops"]
    jpol = dataclasses.replace(jpolicy.tpu_default(0.8), block_size=4, use_pallas=True)
    assert led["avg_rate"] == 0.4
    assert (led["dense"], led["nominal"]) == jddpm.flops_per_iter(2, (3, 8, 8), 8, 0.4)
    assert led["policy"] == jddpm.flops_per_iter(2, (3, 8, 8), 8, policy=jpol)[1]
    defaults = td.build_parser().parse_args([])
    assert (defaults.steps, defaults.steps_per_epoch, defaults.batch, defaults.size,
            defaults.timesteps, defaults.channels, defaults.base, defaults.t_dim) == \
        (200, 40, 16, 16, 100, 1, 16, 64)
    assert (defaults.device, defaults.mode, defaults.granularity, defaults.use_pallas) == \
        ("cuda", "both", "channel", False)


def test_train_ddpm_cli_main_writes_samples_and_prints_the_ledger(tmp_path, monkeypatch,
                                                                   capsys):
    out = tmp_path / "samples.npy"
    monkeypatch.setattr("sys.argv", [
        "train_ddpm", "--device", "cpu", "--batch", "2", "--size", "8", "--timesteps", "3",
        "--base", "8", "--t-dim", "16", "--steps", "2", "--steps-per-epoch", "1", "--mode",
        "dense", "--out", str(out)])
    td.main()
    s = np.load(out)
    assert s.shape == (4, 1, 8, 8) and np.isfinite(s).all()
    text = capsys.readouterr().out
    assert "backward FLOPs/iter: dense" in text and "saved at schedule-average rate 0.40" in text
    assert "backward FLOPs of a sparse step (channel, block 128" in text


def test_train_ddpm_cli_wants_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda is allowed")
    args = td.build_parser().parse_args(["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        td.run(args)
