"""The encoder-decoder family (whisper-large-v3) against the JAX package, on the CPU.

The config twin (full width and reduced); then, reduced (the JAX
package's own cut: 2 encoder + 2 decoder layers, 32 frames, fp32): the
site list, ``encode``, the loss and every gradient leaf of one training
step on the dense, gather, ``matmul`` (its plain version here; the JAX
package runs its Pallas kernel in interpret mode) and mask routes, the
launch table, ``decode_slots`` with the encoder's output over the paged
and the contiguous cache, the workload's frames, and the serving CLI's
three engines. Params are made by the JAX package and converted
(``params_from_jax``); inputs are numpy draws from a seed. The engine's
streams against the JAX engine's are ``test_torch_encdec_serve.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.core import policy as jpolicy
from repro.models import model as jlm
from repro.models import transformer as jtransformer
from repro.serve import poisson_workload as jax_poisson_workload
from repro_torch.configs.registry import get_config as tget
from repro_torch.core import backward as tbackward
from repro_torch.core import policy as tpolicy
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as tlm
from repro_torch.models import transformer as ttransformer
from repro_torch.serve import poisson_workload

ARCH = "whisper-large-v3"
ROUTES = ("dense", "gather", "matmul", "mask")
B, S = 2, 12


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    n = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / n) if n > 0 else float(np.linalg.norm(a))


_MODEL = {}


def _model():
    if not _MODEL:
        jcfg, cfg = jget(ARCH).reduced(), tget(ARCH).reduced()
        tree = jax.tree.map(np.asarray, jlm.init_params(jcfg, jax.random.PRNGKey(0)))
        _MODEL.update(jcfg=jcfg, cfg=cfg, tree=tree,
                      params=tlm.params_from_jax(cfg, tree, device="cpu"))
    return _MODEL


def _routes(policy):
    base = policy.paper_default(0.8)
    return {
        "dense": policy.SsPropPolicy(0.0),
        "gather": base,
        "matmul": dataclasses.replace(base, use_pallas=True),
        "mask": dataclasses.replace(base, mask_mode=True),
    }


def _flat(node, prefix=""):
    if isinstance(node, dict):
        return {k2: v2 for k in sorted(node) for k2, v2 in _flat(node[k], f"{prefix}{k}/").items()}
    return {prefix[:-1]: node}


def _named_jax(tree, cfg):
    """name -> array: the encoder's stacked leaves split into
    ``enc/layer_{i}/...``, the decoder's into ``layer_{i}/...``."""
    out = {f"{k}/{p}": v for k in ("embed", "final_norm", "enc_norm")
           for p, v in _flat(tree[k]).items()}
    for key, prefix, n in (("encoder", "enc/layer_", cfg.n_enc_layers),
                           ("decoder", "layer_", cfg.n_layers)):
        for p, v in _flat(tree[key]).items():
            for i in range(n):
                out[f"{prefix}{i}/{p}"] = np.asarray(v)[i]
    return out


def _named_port(tree):
    out = {f"{k}/{p}": v for k in ("embed", "final_norm", "enc_norm")
           for p, v in _flat(tree[k]).items()}
    for key, prefix in (("encoder", "enc/layer_"), ("decoder", "layer_")):
        for i, layer in enumerate(tree[key]["layers"]):
            out.update({f"{prefix}{i}/{p}": v for p, v in _flat(layer).items()})
    return out


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
        "targets": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
        "frames": rng.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(np.float32),
    }


# --- configs ----------------------------------------------------------


@pytest.mark.parametrize("reduce", [False, True])
def test_config_twins_jax(reduce):
    """Every field of the port's config equals the JAX config's, with
    ``param_count`` (the encoder's layers counted), the layer pattern and
    the site list, full width (32 + 32 layers, 1500 frames, heads of 64)
    and reduced (2 + 2 layers, 32 frames)."""
    jcfg, cfg = jget(ARCH), tget(ARCH)
    if reduce:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert (cfg.n_enc_layers, cfg.enc_seq) == ((2, 32) if reduce else (32, 1500))
    assert cfg.padded_vocab == jcfg.padded_vocab
    assert cfg.param_count() == jcfg.param_count()
    assert [dataclasses.astuple(s) for s in ttransformer.period_pattern(cfg)] == [
        dataclasses.astuple(s) for s in jtransformer.period_pattern(jcfg)]
    assert tlm.site_names(cfg) == jlm.site_names(jcfg)


def test_site_names_are_the_encoders_then_the_cross_decoders():
    """``enc/layer_{i}/attn/*`` and the 2-matrix MLP a encoder layer, then
    ``layer_{i}/self/*``, ``layer_{i}/cross/*`` and the MLP a decoder
    layer; the JAX package's list, in its order."""
    m = _model()
    sites, depth = tlm.site_names(m["cfg"])
    assert (list(sites), depth) == (list(jlm.site_names(m["jcfg"])[0]), m["cfg"].n_layers)
    assert sites[:6] == ("enc/layer_0/attn/q", "enc/layer_0/attn/k", "enc/layer_0/attn/v",
                         "enc/layer_0/attn/o", "enc/layer_0/mlp/up", "enc/layer_0/mlp/down")
    assert len(sites) == 6 * 2 + 10 * 2
    assert sites[12:22] == tuple(f"layer_0/{r}/{p}" for r in ("self", "cross")
                                 for p in ("q", "k", "v", "o")) + ("layer_0/mlp/up",
                                                                   "layer_0/mlp/down")


def test_params_from_jax_round_trip():
    m = _model()
    named_j, named_t = _named_jax(m["tree"], m["cfg"]), _named_port(m["params"])
    assert sorted(named_t) == sorted(named_j)
    for name, t in named_t.items():
        np.testing.assert_array_equal(t.numpy(), named_j[name], err_msg=name)


def test_init_params_has_the_jax_layout():
    """The port's own random params: the JAX tree's names and shapes."""
    m = _model()
    params = tlm.init_params(m["cfg"], 0, device="cpu")
    named_t, named_j = _named_port(params), _named_jax(m["tree"], m["cfg"])
    assert {k: tuple(v.shape) for k, v in named_t.items()} == {
        k: tuple(v.shape) for k, v in named_j.items()}


# --- encoder, training ------------------------------------------------


def test_encode_matches_jax():
    """The normed encoder output over the frames (non-causal, RoPE at
    the frame positions) within 1e-5."""
    m = _model()
    frames = _batch(m["cfg"])["frames"]
    ref = jlm.encode(m["jcfg"], jax.tree.map(jnp.asarray, m["tree"]), jnp.asarray(frames))
    with torch.no_grad():
        out = tlm.encode(m["cfg"], m["params"], torch.from_numpy(frames))
    assert out.shape == (B, m["cfg"].enc_seq, m["cfg"].d_model)
    assert _rel(out.numpy(), ref) <= 1e-5


def test_encoder_is_not_causal():
    """A change to the last frame moves the encoder's output at the first
    frame (every frame sees every other)."""
    m = _model()
    frames = torch.from_numpy(_batch(m["cfg"])["frames"])
    other = frames.clone()
    other[:, -1] += 1.0
    with torch.no_grad():
        a, b = (tlm.encode(m["cfg"], m["params"], f) for f in (frames, other))
    assert not torch.allclose(a[:, 0], b[:, 0])


@pytest.mark.parametrize("route", ROUTES)
def test_loss_and_every_grad_leaf_match_jax(route):
    """One step's loss and ``ce`` and every gradient leaf (encoder,
    decoder, norms, the tied embedding) at relative L2 <= 1e-4. The kept
    channels first: at every sparse site (the encoder's, the
    self-attention's, the cross-attention's K/V over the frames, the
    MLP's) the port's recorded selection equals the nonzero columns of
    the JAX package's dW."""
    m = _model()
    jcfg, cfg = m["jcfg"], m["cfg"]
    jpol, tpol = _routes(jpolicy)[route], _routes(tpolicy)[route]
    batch = _batch(cfg)
    vag = jax.jit(jax.value_and_grad(lambda p, b: jlm.loss_fn(jcfg, p, b, jpol), has_aux=True))
    (lj, mj), gj = vag(jax.tree.map(jnp.asarray, m["tree"]), jax.tree.map(jnp.asarray, batch))
    params = tlm.params_from_jax(cfg, m["tree"], device="cpu")
    site_of = {t.data_ptr(): name[:-2] for name, t in _named_port(params).items()
               if name.endswith("/w")}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with tbackward.record_selections() as log:
        (lt, mt), gt = tsteps.value_and_grad(lambda p: tlm.loss_fn(cfg, p, tb, tpol), params)
    assert abs(float(lt) - float(lj)) <= 1e-4 * abs(float(lj))
    assert abs(float(mt["ce"]) - float(mj["ce"])) <= 1e-4 * abs(float(mj["ce"]))
    named_j, named_t = _named_jax(jax.tree.map(np.asarray, gj), jcfg), _named_port(gt)
    assert sorted(named_t) == sorted(named_j)
    assert {site_of[ptr] for ptr, _ in log} == (
        set() if route == "dense" else set(tlm.site_names(cfg)[0]))
    for ptr, sel in log:
        name = site_of[ptr]
        cols = np.flatnonzero(np.abs(named_j[f"{name}/w"]).sum(0))
        np.testing.assert_array_equal(sel.idx.numpy(), cols, err_msg=name)
    for name, g in named_t.items():
        assert tuple(g.shape) == named_j[name].shape, name
        assert _rel(g.numpy(), named_j[name]) <= 1e-4, name


def test_kernel_launch_table(monkeypatch):
    """``kernel_launches_per_step`` counts two ``matmul`` launches (dX, dW)
    a site of the site list: 6 an encoder layer, 10 a decoder layer; a
    reduced step on the ``matmul`` route calls the kernel exactly that
    often. At full width: 32 * 6 + 32 * 10 sites."""
    m = _model()
    cfg = m["cfg"]
    pal = _routes(tpolicy)["matmul"]
    n_sites = len(tlm.site_names(cfg)[0])
    assert n_sites == 6 * cfg.n_enc_layers + 10 * cfg.n_layers
    assert tlm.kernel_launches_per_step(cfg, pal) == {
        "matmul": 2 * n_sites, "dx_gathered": 0, "dw_gathered": 0}
    assert tlm.kernel_launches_per_step(tget(ARCH), pal)["matmul"] == 2 * (32 * 6 + 32 * 10)
    calls = []
    real = tops.matmul
    monkeypatch.setattr(tops, "matmul", lambda a, b: calls.append(1) or real(a, b))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    tsteps.value_and_grad(lambda p: tlm.loss_fn(cfg, p, batch, pal), m["params"])
    assert len(calls) == 2 * n_sites


def test_train_step_takes_frames_in_the_batch():
    """``make_train_step`` over a batch with frames, two microbatches: a
    finite loss, and every param moved."""
    from repro_torch.optim import adam

    m = _model()
    cfg = m["cfg"]
    params = tlm.params_from_jax(cfg, m["tree"], device="cpu")
    before = {k: v.clone() for k, v in _named_port(params).items()}
    opt = adam.init(params)
    step = tsteps.make_train_step(cfg, tpolicy.paper_default(0.8), adam.AdamConfig(lr=1e-3),
                                  accum=2)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    params, opt, metrics = step(params, opt, batch)
    assert np.isfinite(float(metrics["loss"]))
    moved = [k for k, v in _named_port(params).items() if not torch.equal(v, before[k])]
    assert sorted(moved) == sorted(before)


# --- decode -----------------------------------------------------------


@pytest.mark.parametrize("paged", [True, False])
def test_decode_slots_with_enc_out_match_jax(paged):
    """Two mixed steps (a prefill chunk, a mid-cache chunk, a decode
    token, an idle slot; then a decode token each) from empty caches,
    each slot with its own encoder output: the logits at each slot's last
    token within a relative L2 of 1e-4. The JAX side's paged route runs
    its Pallas kernel (interpret mode)."""
    m = _model()
    jcfg, cfg = m["jcfg"], m["cfg"]
    jp = jax.tree.map(jnp.asarray, m["tree"])
    b, c, bs, nb = 4, 6, 4, 4
    rng = np.random.default_rng(1)
    frames = rng.standard_normal((b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    jenc = jlm.encode(jcfg, jp, jnp.asarray(frames))
    with torch.no_grad():
        tenc = tlm.encode(cfg, m["params"], torch.from_numpy(frames))
    if paged:
        jcache = jlm.init_paged_cache(jcfg, b, b * nb, bs, jnp.float32)
        cache = tlm.init_paged_cache(cfg, b * nb, bs, torch.float32, "cpu")
        tables = rng.permutation(b * nb).reshape(b, nb).astype(np.int32)
        tkw = dict(block_tables=torch.from_numpy(tables), paged_kernel=True)
        jkw = dict(block_tables=jnp.asarray(tables), paged_kernel=True)
    else:
        jcache = jlm.init_cache(jcfg, b, nb * bs, jnp.float32)
        cache = tlm.init_cache(cfg, b, nb * bs, torch.float32, "cpu")
        tkw, jkw = {}, {}
    assert len(cache) == cfg.n_layers and all(set(layer) == {"k", "v"} for layer in cache)
    pos = np.array([0, 5, 9, 3], np.int32)
    for width, count in ((c, np.array([6, 4, 1, 0], np.int32)),
                         (1, np.array([1, 1, 1, 0], np.int32))):
        toks = rng.integers(0, cfg.vocab, (b, width)).astype(np.int32)
        lj, jcache = jlm.decode_slots(jcfg, jp, jnp.asarray(toks), jcache, jnp.asarray(pos),
                                      jnp.asarray(count), enc_out=jenc, **jkw)
        with torch.no_grad():
            lt, cache = tlm.decode_slots(cfg, m["params"], torch.from_numpy(toks), cache,
                                         torch.from_numpy(pos), torch.from_numpy(count),
                                         enc_out=tenc, **tkw)
        live = count > 0
        assert _rel(lt.numpy()[live, : cfg.vocab], np.asarray(lj)[live, : cfg.vocab]) <= 1e-4
        pos = pos + count
    for li, layer in enumerate(cache):
        ref = np.asarray(jcache["k"])[li]
        assert _rel(layer["k"][: len(ref)].numpy(), ref) <= 1e-5, li  # the sink past them


def test_decode_step_needs_the_encoder_output():
    m = _model()
    cache = tlm.init_cache(m["cfg"], 1, 8, torch.float32, "cpu")
    with pytest.raises(ValueError, match="enc_out"):
        tlm.decode_step(m["cfg"], m["params"], torch.zeros((1, 1), dtype=torch.int32), cache, 0)


# --- serving ----------------------------------------------------------


@pytest.mark.parametrize("sampled", [False, True])
def test_poisson_workload_frames_match_jax(sampled):
    """Each request's frames (standard normal ``[32, 128]`` fp32, drawn
    right after its prompt), prompt, lengths, arrival and seed equal the
    JAX generator's from the same seed."""
    m = _model()
    kw = dict(n_requests=5, arrival_rate=2.0, prompt_len=(3, 7), gen_len=(5, 9), seed=5)
    if sampled:
        kw.update(temperature=0.8, top_k=50, top_p=0.95)
    ours, ref = poisson_workload(m["cfg"], **kw), jax_poisson_workload(m["jcfg"], **kw)
    for a, b in zip(ours, ref, strict=True):
        assert a.frames.dtype == np.float32 and a.frames.shape == (32, 128)
        np.testing.assert_array_equal(a.frames, b.frames)
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert (a.max_new_tokens, a.arrival) == (b.max_new_tokens, b.arrival)
        assert a.sampling.seed == b.sampling.seed


def test_engine_refuses_a_request_without_frames():
    from repro_torch.serve import ContinuousBatchingEngine, Request, ServeConfig

    m = _model()
    eng = ContinuousBatchingEngine(m["cfg"], m["params"], ServeConfig(max_slots=2, max_seq=16),
                                   device="cpu")
    with pytest.raises(ValueError, match="frames"):
        eng.submit(Request(rid=0, prompt=np.array([1, 2], np.int32), max_new_tokens=2))


def test_cli_engines_agree():
    """``--arch whisper-large-v3 --reduced --device cpu``, sampled: the
    paged engine (kernel route; with a small pool, swap and a 1-layer
    drafter too), the contiguous one and the lock-step waves with the
    workload's frames give the same tokens."""
    base = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2", "--requests", "4",
            "--prompt-len", "6", "--gen", "6", "--prefill-chunk", "4", "--block-size", "4",
            "--arrival-rate", "0.5", "--temperature", "0.8", "--top-k", "50", "--top-p", "0.95"]
    ap = tserve.build_parser()
    outs = {
        "paged": tserve.run(ap.parse_args(base)),
        "swap-spec": tserve.run(ap.parse_args([*base, "--n-blocks", "5", "--preempt", "swap",
                                               "--spec-k", "2", "--draft-layers", "1"])),
        "continuous": tserve.run(ap.parse_args([*base, "--engine", "continuous"])),
        "lockstep": tserve.run(ap.parse_args([*base, "--engine", "lockstep"])),
    }
    ref = outs["paged"]["generated"]
    assert ref.shape == (4, 6)
    for name, out in outs.items():
        np.testing.assert_array_equal(out["generated"], ref, err_msg=name)
    assert outs["swap-spec"]["swap_preemptions"] > 0 and outs["swap-spec"]["spec_proposed"] > 0
