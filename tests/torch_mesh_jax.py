"""The JAX package's one-device side of the family mesh tests.

``test_torch_mesh_moe.py``, ``test_torch_mesh_ssm.py`` and
``test_torch_mesh_encdec.py`` hold the port's mesh runs (the rank bodies
in ``torch_mesh_ranks.py``) to what is here: the JAX package's init, its
one-device training steps (losses, kept channels of every site and
routed expert, ``dropped`` a MoE layer, the final params) and its
serving engine's streams and counters.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.registry import get_config as jax_get_config
from repro.core import policy as jpolicy
from repro.data import pipeline as jpipe
from repro.launch import steps as jsteps
from repro.models import model as jlm
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro.optim import adam as jadam
from repro.serve import ContinuousBatchingEngine as JaxEngine
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import poisson_workload as jax_poisson_workload

STEPS = 3
TOL = 1e-5
COUNTERS = ("compute_steps", "preemptions", "swap_preemptions", "recompute_preemptions",
            "spec_proposed", "spec_accepted", "draft_steps")
_EXPERT = ("moe/gate", "moe/up", "moe/down")


def config(arch, **overrides):
    return dataclasses.replace(jax_get_config(arch).reduced(), **overrides)


def init(jcfg, seed=0):
    """The JAX init from ``PRNGKey(seed)``, as numpy (the port's input)."""
    return jax.tree.map(np.asarray, jlm.init_params(jcfg, jax.random.PRNGKey(seed)))


def jax_params(tree):
    """A numpy tree (:func:`init`) as the JAX package's arrays."""
    return jax.tree.map(jnp.asarray, tree)


def batches(jcfg, b, s, seed=0):
    """The steps' batches: the JAX pipeline's tokens, plus frames or
    patches (fp32 standard normal draws) for encdec and vlm."""
    pipe = jpipe.TokenPipeline(jpipe.TokenPipelineConfig(jcfg.vocab, s, b, seed=seed))
    rng = np.random.default_rng(seed + 7)
    out = []
    for step in range(STEPS):
        batch = dict(pipe.batch_at(step))
        if jcfg.family == "encdec":
            batch["frames"] = rng.standard_normal((b, jcfg.enc_seq, jcfg.d_model),
                                                  dtype=np.float32)
        if jcfg.family == "vlm":
            batch["patches"] = rng.standard_normal((b, jcfg.n_patches, jcfg.d_model),
                                                   dtype=np.float32)
        out.append(batch)
    return out


def named(tree, jcfg):
    """``name -> array`` in the port's ``train.named_params`` naming."""
    out = {}

    def walk(node, prefix, li=None):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}{k}/", li)
        else:
            a = np.asarray(node)
            out[prefix[:-1]] = a if li is None else a[li]

    stacks = ("stack", "encoder", "decoder")
    walk({k: v for k, v in tree.items() if k not in stacks}, "")
    if jcfg.family == "encdec":
        for i in range(jcfg.n_enc_layers):
            walk(tree["encoder"], f"enc/layer_{i}/", i)
        for i in range(jcfg.n_layers):
            walk(tree["decoder"], f"layer_{i}/", i)
        return out
    plen = len(jtransformer.period_pattern(jcfg))
    for li in range(jcfg.n_layers):
        walk(tree["stack"]["slots"][li % plen], f"layer_{li}/", li // plen)
    return out


def _kept(grads, jcfg):
    """Each site's kept output channels (the nonzero columns of its dW),
    a routed expert's under ``{site}[e]``."""
    g = named(grads, jcfg)
    out = {}
    for site in jlm.site_names(jcfg)[0]:
        if site.split("/", 1)[1] in _EXPERT:
            for e, w in enumerate(g[site]):
                out[f"{site}[{e}]"] = np.flatnonzero(np.abs(w).sum(0)).tolist()
        else:
            out[site] = np.flatnonzero(np.abs(g[f"{site}/w"]).sum(0)).tolist()
    return out


def _dropped(jcfg, params, batch):
    """``dropped`` of every MoE layer of one eager forward (the unrolled
    stack, so each layer's value is concrete)."""
    got, raw = [], jmoe.moe_apply

    def recorded(*a, **k):
        y, m = raw(*a, **k)
        got.append(float(m["dropped"]))
        return y, m

    jmoe.moe_apply = recorded
    try:
        jlm.loss_fn(dataclasses.replace(jcfg, scan_layers=False), params, batch)
    finally:
        jmoe.moe_apply = raw
    return got


def train(jcfg, tree, steps_batches, lr):
    """The JAX package's one-device steps: dense, then two at
    ``paper_default(0.8)``. Returns the losses, each step's ``dropped``,
    the kept channels of each sparse step and the final params."""
    pol = jpolicy.paper_default(0.8)
    ocfg = jadam.AdamConfig(lr=lr, clip_norm=1.0, total_steps=STEPS)
    params = jax.tree.map(jnp.asarray, tree)
    opt = jadam.init(params)
    grad = jax.jit(jax.grad(lambda p, b: jlm.loss_fn(jcfg, p, b, pol)[0]))
    steps = {p: jax.jit(jsteps.make_train_step(jcfg, p, ocfg)) for p in (jpolicy.DENSE, pol)}
    losses, kept, dropped = [], {}, []
    for step, p in enumerate((jpolicy.DENSE, pol, pol)):
        batch = jax.tree.map(jnp.asarray, steps_batches[step])
        dropped.append(_dropped(jcfg, params, batch) if jcfg.is_moe else [])
        if p is pol:
            kept[step] = _kept(grad(params, batch), jcfg)
        params, opt, m = steps[p](params, opt, batch)
        losses.append(float(m["loss"]))
    return {"history": losses, "kept": kept, "dropped": dropped,
            "params": named(jax.tree.map(np.asarray, params), jcfg)}


def assert_matches(got, want, what):
    """Losses and every final param within ``TOL``, the kept channels of
    every site and expert equal, ``dropped`` equal."""
    for a, b in zip(got["history"], want["history"], strict=True):
        assert abs(a - b) <= TOL * abs(b), (what, got["history"], want["history"])
    for step, sites in want["kept"].items():
        assert sorted(got["kept"][step]) == sorted(sites), (what, step)
        for site, cols in sites.items():
            assert got["kept"][step][site] == cols, (what, step, site)
    assert got["dropped"] == want["dropped"], (what, got["dropped"], want["dropped"])
    assert sorted(got["params"]) == sorted(want["params"])
    for name, p in got["params"].items():
        err = float(np.abs(p.numpy() - want["params"][name]).max())
        assert err <= TOL, (what, name, err)


def engine_runs(jcfg, jparams, modes, max_seq):
    """The one-device JAX engine's streams and stats in every mode
    (``modes[name] = (workload kwargs, ServeConfig kwargs, drafter?,
    greedy-every-other?)``; no drafter here)."""
    out = {}
    for name, (wkw, skw, _, mixed) in modes.items():
        skw = {k: v for k, v in skw.items() if k != "attn_kernel"}
        eng = JaxEngine(jcfg, jparams, JaxServeConfig(max_seq=max_seq, prefill_chunk=4, **skw))
        reqs = jax_poisson_workload(jcfg, **wkw)
        if mixed:
            for r in reqs[::2]:
                r.sampling = type(r.sampling)()
        for r in reqs:
            eng.submit(r)
        out[name] = ({rid: list(map(int, t)) for rid, t in eng.run().items()}, eng.stats())
    return out


def assert_streams(port, jax_run, name):
    """Every rank's streams are rank 0's and the JAX engine's, and so are
    the counters."""
    streams, stats, launches, _, same = port
    want, jstats = jax_run
    assert same, f"{name}: the ranks' streams differ"
    assert streams == want, name
    for k in COUNTERS:
        assert stats[k] == jstats[k], (name, k)
    assert all(n == 0 for n in launches)  # the plain version on the CPU
