"""The port's LM training path with ssProp against the JAX package's.

Reduced qwen2.5-3b (2 layers, d 128, fp32). Params are made by the JAX
package and converted (``params_from_jax``); batches come from the
numpy token pipeline and are handed to both packages. On the CPU the
port's ``matmul`` kernel runs its plain version and the JAX package's
runs its Pallas kernel in interpret mode. Covered: the token pipeline
and the per-site policy tables; the loss and every gradient leaf on the
dense, gather, ``matmul`` and mask routes (and a per-site table), with
the kept channels compared first; two train steps at ``accum`` 1 and 2;
the launch table; the CLI.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core import policy as jpolicy
from repro.core import schedulers as jsched
from repro.data import pipeline as jpipe
from repro.launch import steps as jsteps
from repro.models import model as jlm
from repro.optim import adam as jadam
from repro_torch.configs.registry import get_config
from repro_torch.core import backward as tbackward
from repro_torch.core import policy as tpolicy
from repro_torch.core import schedulers as tsched
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import ops as tops
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import model as tlm
from repro_torch.optim import adam as tadam

ARCH = "qwen2.5-3b"
B, S = 4, 16
RULES = "layer_{0,-1}/*=dense;*/attn/*=0.5;*=0.8"


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    n = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / n) if n > 0 else float(np.linalg.norm(a))


@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    tree = jax.tree.map(np.asarray, jlm.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, cfg, tree


def _batch(cfg, step=0, batch=B):
    return jpipe.TokenPipeline(jpipe.TokenPipelineConfig(cfg.vocab, S, batch, seed=0)).batch_at(step)


def _flat(node, prefix=""):
    if isinstance(node, dict):
        return {k2: v2 for k in sorted(node) for k2, v2 in _flat(node[k], f"{prefix}{k}/").items()}
    return {prefix[:-1]: node}


def _named_jax(tree, n_layers):
    """name -> array, the stacked layer leaves split into ``layer_{li}/...``."""
    out = {f"{k}/{p}": v for k in ("embed", "final_norm") for p, v in _flat(tree[k]).items()}
    for p, v in _flat(tree["stack"]["slots"][0]).items():
        for li in range(n_layers):
            out[f"layer_{li}/{p}"] = np.asarray(v)[li]
    return out


def _named_port(tree):
    out = {f"{k}/{p}": v for k in ("embed", "final_norm") for p, v in _flat(tree[k]).items()}
    for li, layer in enumerate(tree["stack"]["layers"]):
        out.update({f"layer_{li}/{p}": v for p, v in _flat(layer).items()})
    return out


# --- host-side copies -------------------------------------------------


@pytest.mark.parametrize("vocab,seq,batch,seed", [(512, 16, 4, 0), (151936, 33, 3, 7)])
def test_token_pipeline_identical(vocab, seq, batch, seed):
    jp = jpipe.TokenPipeline(jpipe.TokenPipelineConfig(vocab, seq, batch, seed))
    tp = tpipe.TokenPipeline(tpipe.TokenPipelineConfig(vocab, seq, batch, seed))
    for step in (0, 1, 5):
        bj, bt = jp.batch_at(step), tp.batch_at(step)
        assert sorted(bt) == sorted(bj) == ["targets", "tokens"]
        for k in bj:
            assert bt[k].dtype == bj[k].dtype
            np.testing.assert_array_equal(bt[k], bj[k])


def _entries(table):
    return ([(n, dataclasses.asdict(p)) for n, p in table.entries],
            dataclasses.asdict(table.default))


@pytest.mark.parametrize("reduce", [True, False])
@pytest.mark.parametrize("rules", ["", RULES, "layer_{0..1}/mlp/*=0.5;layer_{-2..-1}/attn/{q,k}=dense;*=0.8"])
def test_site_policies_match_jax(rules, reduce):
    """The resolved table over ``site_names``, the per-step tables of an
    epoch-bar program, ``scoped`` and ``uniform``, equal to the JAX
    package's."""
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    if reduce:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    (jsites, jdepth), (tsites, tdepth) = jlm.site_names(jcfg), tlm.site_names(cfg)
    assert tsites == jsites and tdepth == jdepth
    progs = []
    for pol, sch in ((jpolicy, jsched), (tpolicy, tsched)):
        base = dataclasses.replace(pol.paper_default(0.8), use_pallas=True)
        r = pol.PolicyRules.parse(rules, base) if rules else pol.PolicyRules.single(base)
        schedule = sch.make_schedule("epoch_bar", target=0.8, total_steps=6, steps_per_epoch=2)
        progs.append(pol.PolicyProgram(rules=r, schedule=schedule).resolve(jsites, depth=jdepth))
    jprog, tprog = progs
    assert _entries(tprog.sites) == _entries(jprog.sites)
    for step in range(6):
        assert _entries(tprog.policies_for_step(step)) == _entries(jprog.policies_for_step(step))
    assert _entries(tprog.peak().scoped("layer_1")) == _entries(jprog.peak().scoped("layer_1"))
    for t, j in ((tprog.peak(), jprog.peak()), (tprog.at_scale(0.0), jprog.at_scale(0.0))):
        tu, ju = t.uniform(), j.uniform()
        assert (tu is None) == (ju is None)
        if tu is not None:
            assert dataclasses.asdict(tu) == dataclasses.asdict(ju)
    for name in jsites[:9]:
        assert dataclasses.asdict(tpolicy.policy_for(tprog.peak(), name)) == \
            dataclasses.asdict(jpolicy.policy_for(jprog.peak(), name))


def test_policy_patterns_match_jax():
    for pattern in ("layer_{0,-1}/*", "layer_{2..5}/mlp/{up,down}", "layer_{0..-2}/attn/q"):
        assert tpolicy.expand_pattern(pattern, 8) == jpolicy.expand_pattern(pattern, 8)
    with pytest.raises(ValueError, match="negative index"):
        tpolicy.expand_pattern("layer_{-1}/*")
    with pytest.raises(ValueError, match="pattern=rate"):
        tpolicy.PolicyRules.parse("=0.5", tpolicy.paper_default())
    pol = tpolicy.PolicyProgram.single(tpolicy.SsPropPolicy(0.3))
    jp = jpolicy.PolicyProgram.single(jpolicy.SsPropPolicy(0.3))
    assert _entries(pol.resolve(["a"]).policies_for_step(4)) == \
        _entries(jp.resolve(["a"]).policies_for_step(4))


# --- loss and gradients -------------------------------------------------


def _routes(mod):
    sparse = mod.paper_default(0.8)
    return {
        "dense": mod.DENSE,
        "gather": sparse,
        "matmul": dataclasses.replace(sparse, use_pallas=True),
        "mask": dataclasses.replace(sparse, mask_mode=True),
    }


def _table(mod, cfg, site_names):
    """The per-site route: RULES on the ``matmul`` route, at its peak."""
    base = dataclasses.replace(mod.paper_default(0.8), use_pallas=True)
    sites, depth = site_names(cfg)
    return mod.PolicyRules.parse(RULES, base).resolve(sites, depth=depth)


@pytest.mark.parametrize("route", ["dense", "gather", "matmul", "mask", "rules"])
def test_loss_and_every_grad_leaf_match_jax(model, route):
    """One step's loss and every gradient leaf at relative L2 <= 1e-4.
    The kept channels first: at every sparse site the port's recorded
    selection equals the nonzero columns of the JAX package's dW (dropped
    columns are exactly 0 on every sparse route)."""
    jcfg, cfg, tree = model
    if route == "rules":  # per-depth rules need the JAX package's unrolled stack
        jcfg = dataclasses.replace(jcfg, scan_layers=False)
        jpol, tpol = _table(jpolicy, jcfg, jlm.site_names), _table(tpolicy, cfg, tlm.site_names)
    else:
        jpol, tpol = _routes(jpolicy)[route], _routes(tpolicy)[route]
    batch = _batch(cfg)
    vag = jax.jit(jax.value_and_grad(lambda p, b: jlm.loss_fn(jcfg, p, b, jpol), has_aux=True))
    (lj, _), gj = vag(jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch))
    params = tlm.params_from_jax(cfg, tree, device="cpu")
    site_of = {layer[r][p]["w"].data_ptr(): f"layer_{li}/{r}/{p}"
               for li, layer in enumerate(params["stack"]["layers"])
               for r, projs in (("attn", "qkvo"), ("mlp", ("gate", "up", "down"))) for p in projs}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with tbackward.record_selections() as log:
        (lt, mt), gt = tsteps.value_and_grad(lambda p: tlm.loss_fn(cfg, p, tb, tpol), params)
    assert abs(float(lt) - float(lj)) <= 1e-4 * abs(float(lj))
    assert float(mt["ce"]) == float(lt) and float(mt["aux"]) == 0.0
    named_j, named_t = _named_jax(jax.tree.map(np.asarray, gj), cfg.n_layers), _named_port(gt)
    assert sorted(named_t) == sorted(named_j)

    kept = {site_of[ptr]: sel for ptr, sel in log}
    sparse_sites = [s for s in tlm.site_names(cfg)[0] if tpolicy.policy_for(tpol, s).active]
    assert sorted(kept) == sorted(sparse_sites)
    for site, sel in kept.items():
        cols = np.flatnonzero(np.abs(named_j[f"{site}/w"]).sum(0))
        np.testing.assert_array_equal(sel.idx.numpy(), cols, err_msg=site)
        assert sel.k == tpolicy.policy_for(tpol, site).keep_count(named_j[f"{site}/w"].shape[1])
    for name, g in named_t.items():
        assert tuple(g.shape) == named_j[name].shape, name
        assert _rel(g.numpy(), named_j[name]) <= 1e-4, name


@pytest.mark.parametrize("accum", [1, 2])
def test_two_train_steps_match_jax(model, accum):
    """``make_train_step`` over an epoch-bar program (step 0 dense, step
    1 sparse on the ``matmul`` route), Adam with clipping: the losses and
    grad norms at 1e-4, and every param element after the two steps
    within 0.1 lr of the reference's. Adam moves each element by about lr
    whatever its gradient's size, so where a gradient is rounding noise
    (the key bias: softmax is shift-invariant but for RoPE) or two steps'
    gradients nearly cancel, the frameworks' last-bit differences move
    m/sqrt(v) by a few percent of lr (measured: at most 0.053 lr)."""
    jcfg, cfg, tree = model
    ocfg_j = jadam.AdamConfig(lr=1e-3, clip_norm=1.0, total_steps=2)
    ocfg_t = tadam.AdamConfig(lr=1e-3, clip_norm=1.0, total_steps=2)
    progs = []
    for pol, sch in ((jpolicy, jsched), (tpolicy, tsched)):
        base = dataclasses.replace(pol.paper_default(0.8), use_pallas=True)
        schedule = sch.make_schedule("epoch_bar", target=0.8, steps_per_epoch=1)
        progs.append(pol.PolicyProgram(pol.PolicyRules.single(base), schedule).resolve(
            tlm.site_names(cfg)[0], depth=cfg.n_layers))
    jprog, tprog = progs
    pj = jax.tree.map(jnp.asarray, tree)
    oj = jadam.init(pj)
    pt = tlm.params_from_jax(cfg, tree, device="cpu")
    ot = tadam.init(pt)
    for step in range(2):
        batch = _batch(cfg, step)
        fj = jax.jit(jsteps.make_train_step(jcfg, jprog.policies_for_step(step), ocfg_j,
                                            accum=accum))
        pj, oj, mj = fj(pj, oj, jax.tree.map(jnp.asarray, batch))
        ft = tsteps.make_train_step(cfg, tprog.policies_for_step(step), ocfg_t, accum=accum)
        pt, ot, mt = ft(pt, ot, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert abs(float(mt["loss"]) - float(mj["loss"])) <= 1e-4 * abs(float(mj["loss"]))
        assert abs(float(mt["grad_norm"]) - float(mj["grad_norm"])) <= \
            1e-4 * float(mj["grad_norm"])
    assert int(ot.step) == int(oj.step) == 2
    named_j = _named_jax(jax.tree.map(np.asarray, pj), cfg.n_layers)
    named_t = _named_port(pt)
    assert sorted(named_t) == sorted(named_j)
    for name, p in named_t.items():
        assert np.abs(p.numpy() - named_j[name]).max() <= 0.1 * ocfg_t.lr, name


def test_eval_step_matches_jax(model):
    """The dense cross-entropy, with no graph built."""
    jcfg, cfg, tree = model
    batch = _batch(cfg, 3)
    ce_j = jax.jit(jsteps.make_eval_step(jcfg))(jax.tree.map(jnp.asarray, tree),
                                               jax.tree.map(jnp.asarray, batch))
    params = tadam.tree_map(lambda t: t.requires_grad_(True),
                            tlm.params_from_jax(cfg, tree, device="cpu"))
    ce_t = tsteps.make_eval_step(cfg)(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert ce_t.grad_fn is None
    assert abs(float(ce_t) - float(ce_j)) <= 1e-5 * abs(float(ce_j))


@pytest.mark.parametrize("clip,decay", [(1.0, 0.0), (0.0, 0.01), (1e-3, 0.0)])
def test_adam_in_place_equals_functional(clip, decay):
    """``apply_updates(..., inplace=True)`` gives the functional step's
    numbers bit for bit, in the tensors it was given."""
    rng = np.random.default_rng(2)
    shapes = {"a": (5, 7), "b": [(3,), (2, 4)]}

    def tree(dtype):
        return {"a": torch.from_numpy(rng.standard_normal(shapes["a"]).astype(np.float32)).to(dtype),
                "b": [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
                      for s in shapes["b"]]}

    cfg = tadam.AdamConfig(lr=1e-2, clip_norm=clip, weight_decay=decay)
    for dtype in (torch.float32, torch.bfloat16):
        params, state = tree(dtype), tadam.init(tree(dtype))
        ip = tadam.tree_map(torch.clone, params)
        istate = tadam.AdamState(state.step.clone(), tadam.tree_map(torch.clone, state.m),
                                 tadam.tree_map(torch.clone, state.v))
        for _ in range(3):
            grads = tree(dtype)
            params, state, m1 = tadam.apply_updates(cfg, params, grads, state)
            leaf = tadam.tree_leaves(ip)[0]
            ip, istate, m2 = tadam.apply_updates(cfg, ip, tadam.tree_map(torch.clone, grads),
                                                 istate, inplace=True)
            assert tadam.tree_leaves(ip)[0] is leaf  # updated where it lies
            assert torch.equal(m1["grad_norm"], m2["grad_norm"])
        for a, b in zip(tadam.tree_leaves((params, state.m, state.v)),
                        tadam.tree_leaves((ip, istate.m, istate.v)), strict=True):
            assert a.dtype == b.dtype and torch.equal(a, b)


# --- the launch table ---------------------------------------------------


def test_kernel_launch_table(monkeypatch):
    """``kernel_launches_per_step`` by the engine's rules, and the engine
    calling ``matmul`` exactly that often in one reduced step."""
    full, small = get_config(ARCH), get_config(ARCH).reduced()
    pal = dataclasses.replace(tpolicy.paper_default(0.8), use_pallas=True)
    assert tlm.kernel_launches_per_step(full, pal) == {
        "matmul": 504, "dx_gathered": 0, "dw_gathered": 0}
    assert tlm.kernel_launches_per_step(small, pal)["matmul"] == 28
    assert tlm.kernel_launches_per_step(small, dataclasses.replace(pal, sparsify_dx=False)) == {
        "matmul": 14, "dx_gathered": 0, "dw_gathered": 0}
    for off in (dict(mask_mode=True), dict(use_pallas=False), dict(drop_rate=0.0)):
        assert tlm.kernel_launches_per_step(small, dataclasses.replace(pal, **off)) == {
            "matmul": 0, "dx_gathered": 0, "dw_gathered": 0}
    blk = dataclasses.replace(tpolicy.tpu_default(0.8), block_size=32, use_pallas=True)
    assert tlm.kernel_launches_per_step(small, blk) == {
        "matmul": 0, "dx_gathered": 14, "dw_gathered": 14}

    table = _table(tpolicy, small, tlm.site_names)  # layers 0 and -1 dense: nothing launches
    assert tlm.kernel_launches_per_step(small, table)["matmul"] == 0
    one = tpolicy.PolicyRules.parse("layer_1/mlp/*=dense;*=0.8", pal).resolve(
        tlm.site_names(small)[0], depth=small.n_layers)
    calls = []
    real = tops.matmul
    monkeypatch.setattr(tops, "matmul", lambda a, b: calls.append(1) or real(a, b))
    params = tlm.init_params(small, 0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(small).items()}
    tsteps.value_and_grad(lambda p: tlm.loss_fn(small, p, batch, one), params)
    assert len(calls) == tlm.kernel_launches_per_step(small, one)["matmul"] == 22


# --- the CLI ----------------------------------------------------------


def test_train_cli_on_cpu():
    args = ttrain.build_parser().parse_args(
        ["--device", "cpu", "--reduced", "--steps", "4", "--steps-per-epoch", "2",
         "--global-batch", "2", "--seq-len", "16", "--use-pallas", "--log-every", "1"])
    out = ttrain.run(args)
    assert len(out["history"]) == len(out["step_times"]) == 4
    assert np.isfinite(out["history"]).all() and out["final_loss"] == out["history"][-1]
    assert out["rates"] == [0.0, 0.0, 0.8, 0.8]
    assert out["launches"] == dict.fromkeys(out["launches"], 0)  # the CPU runs plain versions
    defaults = ttrain.build_parser().parse_args([])
    assert (defaults.device, defaults.arch, defaults.global_batch, defaults.seq_len,
            defaults.lr, defaults.granularity, defaults.use_pallas) == \
        ("cuda", ARCH, 8, 128, 2e-4, "channel", False)


@pytest.mark.parametrize("flag", [["--ckpt-dir", "x"], ["--coord-dir", "x"], ["--world-size", "2"],
                                  ["--data-mesh", "2"], ["--model-mesh", "2"],
                                  ["--fail-at-step", "3"]])
def test_train_cli_refuses_what_is_not_ported(flag):
    args = ttrain.build_parser().parse_args(["--device", "cpu", "--reduced", *flag])
    with pytest.raises(NotImplementedError, match="not ported yet"):
        ttrain.run(args)


def test_train_cli_wants_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda is allowed")
    args = ttrain.build_parser().parse_args(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.run(args)
