"""Serving on ``data x model`` meshes against the JAX package, on the CPU.

Reduced qwen2.5-3b (fp32, 4 q heads on 2 KV heads) and the JAX package's
params. One spawn of gloo ranks a mesh size (2 ranks: 2x1 and 1x2; 4
ranks: 2x2; one torch thread a rank, a timeout) runs:

* the engine in every mode of ``tests/test_torch_mesh_serve.py``'s
  ``MODES`` at 4 slots (2 a data rank), plus the contiguous and paged
  engines at 3 slots (every data rank holds every slot; the contiguous
  K/V's sequence then splits over ``data``, as the reference's
  ``fit_spec`` places it), and reduced jamba (attention + Mamba + MoE)
  with swap preemption, whose swapped SSM rows cross data ranks: every
  rank's streams and the counters must be the one-device JAX engine's
  token for token, and every data rank's pool equal to the others' after
  every step;
* the lock-step decode at 1x2, 2x1 and 2x2, seq-sharded over ``model``
  (``decode_seq_shard``), and at batch 1 with ``data`` on the sequence:
  every step's logits within 1e-5 · max(1, max |JAX logit|) of the JAX
  package's one-device ``decode_step`` and the tokens of its
  ``generate_lockstep`` (``make_serve_step``) equal;
* the serving CLI's rank body at 2x2 against the JAX CLI's own ``--data-mesh
  2 --model-mesh 2`` run on 4 host devices in a subprocess.

On the CPU the paged-attention wrapper runs its plain version, so no
launch is counted.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_mesh_ranks as ranks

from repro.configs.registry import get_config as jax_get_config
from repro.models import model as jlm
from repro.serve import ContinuousBatchingEngine as JaxEngine
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import generate_lockstep as jax_generate_lockstep
from repro.serve import poisson_workload as jax_poisson_workload
from repro_torch.configs.registry import get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model as tlm

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
ARCH, HYBRID = "qwen2.5-3b", "jamba-1.5-large-398b"
MAX_SEQ = 24
TIMEOUT_S = 180
LOGIT_TOL = 1e-5
GREEDY = dict(n_requests=6, arrival_rate=2.0, prompt_len=(3, 7), gen_len=(6, 12), seed=5)
SAMPLED = dict(GREEDY, temperature=0.8, top_k=50, top_p=0.95)
PAGED = dict(max_slots=4, block_size=4, n_blocks=24)
SMALL_POOL = dict(max_slots=4, block_size=4, n_blocks=7)
# mode -> (workload, ServeConfig fields, drafter?, every other request greedy?)
MODES = {
    "greedy-kernel": (GREEDY, dict(PAGED, attn_kernel=True), False, False),
    "greedy-gather": (GREEDY, dict(PAGED, attn_kernel=False), False, False),
    "sampled-kernel": (SAMPLED, dict(PAGED, attn_kernel=True), False, False),
    "sampled-gather": (SAMPLED, dict(PAGED, attn_kernel=False), False, False),
    "swap": (SAMPLED, dict(SMALL_POOL, preempt="swap"), False, False),
    "auto": (SAMPLED, dict(SMALL_POOL, preempt="auto"), False, True),
    "contiguous": (SAMPLED, dict(max_slots=4), False, False),
    "spec-drafter": (SAMPLED, dict(PAGED, spec_k=2), True, False),
    "contiguous-3-slots": (SAMPLED, dict(max_slots=3), False, False),
    "paged-3-slots": (SAMPLED, dict(max_slots=3, block_size=4, n_blocks=18), False, False),
}
HYBRID_MODES = {"hybrid-swap": (dict(SAMPLED, n_requests=5, gen_len=(5, 9)),
                                dict(max_slots=4, block_size=4, n_blocks=6, preempt="swap"),
                                False, False)}
COUNTERS = ("compute_steps", "preemptions", "swap_preemptions", "recompute_preemptions",
            "spec_proposed", "spec_accepted", "draft_steps", "swapped_bytes")
ENGINE_SHAPES = ((2, 1), (2, 2))
_PROMPTS = np.random.default_rng(11).integers(0, 512, (4, 5)).astype(np.int32)
LOCK_GEN = 4
# case -> (mesh shape, prompts, config overrides, the layout's sequence split)
LOCK_CASES = {
    "1x2": ((1, 2), _PROMPTS, {}, None),
    "2x1": ((2, 1), _PROMPTS, {}, None),
    "2x2": ((2, 2), _PROMPTS, {}, None),
    "1x2-seq-model": ((1, 2), _PROMPTS, {"decode_seq_shard": True}, "model"),
    "2x2-seq-model": ((2, 2), _PROMPTS, {"decode_seq_shard": True}, "model"),
    "2x1-batch-1-seq-data": ((2, 1), _PROMPTS[:1], {}, "data"),
    "2x2-batch-1-seq-data": ((2, 2), _PROMPTS[:1], {}, "data"),
}
CLI = ["--reduced", "--batch", "2", "--requests", "4", "--prompt-len", "12", "--gen", "8",
       "--prefill-chunk", "4", "--block-size", "4", "--engine", "paged", "--data-mesh", "2",
       "--model-mesh", "2"]


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in (ARCH, HYBRID):
        jcfg = jax_get_config(arch).reduced()
        jdcfg = jcfg.reduced(n_layers=2 if jcfg.attn_every else 1)
        out[arch] = dict(jcfg=jcfg, jdcfg=jdcfg,
                         jparams=jlm.init_params(jcfg, jax.random.PRNGKey(0)),
                         jdparams=jlm.init_params(jdcfg, jax.random.PRNGKey(1)))
    return out


def _jax_engine(m, wkw, skw, draft, mixed):
    skw = {k: v for k, v in skw.items() if k != "attn_kernel"}
    kw = dict(draft_cfg=m["jdcfg"], draft_params=m["jdparams"]) if draft else {}
    eng = JaxEngine(m["jcfg"], m["jparams"],
                    JaxServeConfig(max_seq=MAX_SEQ, prefill_chunk=4, **skw), **kw)
    reqs = jax_poisson_workload(m["jcfg"], **wkw)
    if mixed:
        for r in reqs[::2]:
            r.sampling = type(r.sampling)()
    for r in reqs:
        eng.submit(r)
    return {rid: list(map(int, t)) for rid, t in eng.run().items()}, eng.stats()


@pytest.fixture(scope="module")
def jax_runs(models):
    """The one-device JAX engine's streams and counters in every mode."""
    out = {name: _jax_engine(models[ARCH], *mode) for name, mode in MODES.items()}
    out.update({name: _jax_engine(models[HYBRID], *mode) for name, mode in HYBRID_MODES.items()})
    return out


@pytest.fixture(scope="module")
def jax_lockstep(models):
    """The JAX package's one-device lock-step decode of every case: each
    step's logits (``decode_step``, teacher-forced, then greedy) and
    ``generate_lockstep``'s tokens (``make_serve_step``)."""
    m = models[ARCH]
    step = jax.jit(lambda p, t, c, pos: jlm.decode_step(m["jcfg"], p, t, c, pos))
    out = {}
    for name, (_, prompts, _, _) in LOCK_CASES.items():
        b, p = prompts.shape
        cache = jlm.init_cache(m["jcfg"], b, MAX_SEQ, dtype=jnp.float32)
        tok, logits = jnp.asarray(prompts[:, :1]), []
        for t in range(p + LOCK_GEN - 1):
            lg, cache = step(m["jparams"], tok, cache, jnp.int32(t))
            logits.append(np.asarray(lg))
            tok = (jnp.asarray(prompts[:, t + 1:t + 2]) if t + 1 < p
                   else jnp.argmax(lg, axis=-1).astype(jnp.int32)[:, None])
        res = jax_generate_lockstep(m["jcfg"], m["jparams"], prompts, [LOCK_GEN] * b,
                                    max_seq=MAX_SEQ)
        out[name] = (np.stack(logits), np.stack([np.asarray(t) for t in res["tokens"]]))
    return out


@pytest.fixture(scope="module")
def port_runs(models):
    """Every mesh case, one spawn of gloo ranks a mesh size."""
    tree = jax.tree.map(np.asarray, models[ARCH]["jparams"])
    dtree = jax.tree.map(np.asarray, models[ARCH]["jdparams"])
    htree = jax.tree.map(np.asarray, models[HYBRID]["jparams"])
    calls, keys = {}, {}
    for shape in ((1, 2), (2, 1), (2, 2)):
        todo, names = [], []
        if shape in ENGINE_SHAPES:
            todo.append((ranks.data_serve_cases, (ARCH, tree, dtree, MODES, MAX_SEQ)))
            names.append("engine")
        if shape == (2, 1):
            todo.append((ranks.data_serve_cases, (HYBRID, htree, None, HYBRID_MODES, MAX_SEQ)))
            names.append("hybrid")
        cases = {n: (c[1], LOCK_GEN, c[2]) for n, c in LOCK_CASES.items() if c[0] == shape}
        todo.append((ranks.lockstep_cases, (ARCH, tree, cases, MAX_SEQ)))
        names.append("lockstep")
        if shape == (2, 2):
            todo.append((ranks.serve_cli_rank, (tree, ["--device", "cpu", *CLI])))
            names.append("cli")
        calls[shape] = (ranks.in_turn, (todo,))
        keys[shape] = [(shape, n) for n in names]
    return ranks.spawn_shapes(calls, keys, TIMEOUT_S)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine_run(port_runs, shape, mode):
    key = "hybrid" if mode in HYBRID_MODES else "engine"
    return port_runs[(shape, key)][mode]


ENGINE_CASES = [(s, m) for s in ENGINE_SHAPES for m in MODES] + [((2, 1), m) for m in HYBRID_MODES]


@pytest.mark.parametrize("shape, mode", ENGINE_CASES,
                         ids=[f"{d}x{m}-{mode}" for (d, m), mode in ENGINE_CASES])
def test_engine_streams_are_the_jax_engines(port_runs, jax_runs, shape, mode):
    """Every rank's streams are the JAX engine's, and so are the counters;
    the data ranks stage the same swap bundles (their model ranks' KV
    heads), so one data rank's model ranks' swapped bytes sum to the JAX
    engine's."""
    streams, stats, launches, swapped, same, _, _ = _engine_run(port_runs, shape, mode)
    want, jstats = jax_runs[mode]
    assert same, "the ranks' streams differ"
    assert streams == want
    for k in COUNTERS:
        got = sum(swapped[:shape[1]]) if k == "swapped_bytes" else stats[k]
        assert got == jstats[k], k
    assert launches == [0] * (shape[0] * shape[1])  # the plain version on the CPU
    if "swap" in mode:
        assert stats["swap_preemptions"] > 0


@pytest.mark.parametrize("shape, mode", [(s, m) for s in ENGINE_SHAPES
                                         for m in ("swap", "auto", "greedy-kernel")]
                         + [((2, 1), "hybrid-swap")])
def test_the_pool_is_the_same_on_every_data_rank(port_runs, shape, mode):
    """The paged pool, replicated over ``data``, is bit for bit the same on
    every data rank after every step, swaps included."""
    assert _engine_run(port_runs, shape, mode)[5]


@pytest.mark.parametrize("shape, mode", [((2, 1), "swap"), ((2, 2), "swap"),
                                         ((2, 1), "hybrid-swap")])
def test_a_swap_returns_into_a_slot_another_data_rank_holds(port_runs, jax_runs, shape, mode):
    """A swapped-out request comes back into a slot held by another data
    rank than the one it left (its SSM rows, for the hybrid, staged from
    their owner), and the streams stay the JAX engine's."""
    streams, _, _, _, _, _, swaps = _engine_run(port_runs, shape, mode)
    per = 4 // shape[0]  # slots a data rank
    assert any(a // per != b // per for a, b in swaps), swaps
    assert streams == jax_runs[mode][0]


@pytest.mark.parametrize("case", sorted(LOCK_CASES))
def test_lockstep_matches_the_jax_serve_step(port_runs, jax_lockstep, case):
    """Every step's logits within ``LOGIT_TOL · max(1, max |JAX logit|)``
    of the JAX package's one-device ``decode_step`` (fp32; summation
    order, and the seq-sharded partial softmaxes' combine), and the
    lock-step engine's tokens equal to its ``generate_lockstep``'s; the
    cache layout splits the sequence where the case says."""
    shape, prompts, _, seq = LOCK_CASES[case]
    logits, tokens, (slots, got_seq, whole) = port_runs[(shape, "lockstep")][case]
    want_logits, want_tokens = jax_lockstep[case]
    assert got_seq == seq and not whole
    assert (slots != (0, len(prompts))) == (shape[0] > 1 and len(prompts) > 1)
    assert logits.shape == want_logits.shape
    err = np.abs(logits - want_logits).max()
    assert err <= LOGIT_TOL * max(1.0, np.abs(want_logits).max()), err
    np.testing.assert_array_equal(tokens, want_tokens)


_JAX_CLI = """
import json, sys
sys.path.insert(0, {src!r})
from repro.launch import serve
args = serve.build_parser().parse_args({argv!r})
print("RESULT " + json.dumps(serve.run(args)["generated"].tolist()))
"""


def test_the_jax_clis_command_line_on_a_2x2_mesh(port_runs):
    """The JAX CLI's ``--data-mesh 2 --model-mesh 2`` run (4 host devices,
    GSPMD) and the port's serving CLI rank body on 4 gloo ranks, from the
    same init, generate the same tokens."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_CLI.format(src=SRC, argv=CLI)], env=env,
                          capture_output=True, text=True, timeout=150)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    want = json.loads(next(ln for ln in proc.stdout.splitlines()
                           if ln.startswith("RESULT "))[len("RESULT "):])
    assert port_runs[((2, 2), "cli")] == want


# ----------------------------------------------------------------------
# the layouts, from the reference's fitted cache specs (no spawn)
# ----------------------------------------------------------------------


@pytest.mark.parametrize("arch, shape, policy, slots, seq, whole", [
    ("qwen2.5-3b", "decode_32k", "ssprop", (0, 8), None, ()),
    ("qwen2.5-3b", "decode_32k", "opt", (0, 8), "model", ()),
    ("jamba-1.5-large-398b", "long_500k", "ssprop", (0, 1), "data", ("['state']: data on its state",)),
    ("jamba-1.5-large-398b", "long_500k", "opt", (0, 1), "model", ("['k']: data on its head",)),
    ("mamba2-1.3b", "long_500k", "ssprop", (0, 1), None, ("layer-stack",)),
    ("mamba2-1.3b", "long_500k", "opt", (0, 1), None, ("layer-stack",)),
])
def test_the_production_cache_layouts(arch, shape, policy, slots, seq, whole):
    """On 16x16: the slots split over ``data`` where the batch takes it;
    under ``opt`` the sequence over ``model``; at batch 1 ``data`` follows
    ``fit_spec`` onto jamba's K/V sequence, and where it lands on a dim the
    step does not split (jamba's SSM leaves, mamba2's layer stack) the
    rank holds the leaf whole, saying so."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import dryrun

    ms = tmesh.production_mesh_shape()
    cfg, _ = dryrun.resolve(arch, policy, ms)
    layout = tlm.cache_layout(cfg, tmesh.shape_mesh(ms), SHAPES[shape].global_batch,
                              SHAPES[shape].seq_len, seq_shard=cfg.decode_seq_shard)
    assert (layout.slots, layout.seq) == (slots, seq)
    assert all(any(w in msg for msg in layout.whole) for w in whole), layout.whole
    assert bool(layout.whole) == bool(whole)


def test_a_batch_the_data_size_does_not_divide_is_held_by_every_data_rank():
    """3 slots on 2 data ranks: every data rank holds every slot (the
    contiguous K/V split on the sequence instead), and the paged pool's
    layout splits nothing over ``data``."""
    cfg = get_config(ARCH).reduced()
    mesh = tmesh.shape_mesh({"data": 2, "model": 1}, rank=1)
    contiguous = tlm.cache_layout(cfg, mesh, 3, MAX_SEQ)
    paged = tlm.cache_layout(cfg, mesh, 3, MAX_SEQ, paged=True)
    assert (contiguous.slots, contiguous.seq, contiguous.split) == ((0, 3), "data", False)
    assert (paged.slots, paged.seq, paged.whole) == ((0, 3), None, ())
    split = tlm.cache_layout(cfg, mesh, 4, MAX_SEQ)
    assert (split.slots, split.seq, split.owner(1), split.owner(2)) == ((2, 4), None, 0, 1)
    cache = tlm.init_local_cache(cfg, split, mesh, max_seq=MAX_SEQ, device="cpu")
    kv = cfg.n_kv_heads
    assert tuple(cache[0]["k"].shape) == (2, MAX_SEQ, kv, cfg.head_dim)
    seq = tlm.init_local_cache(cfg, contiguous, mesh, max_seq=MAX_SEQ, device="cpu")
    assert tuple(seq[0]["k"].shape) == (3, MAX_SEQ // 2, kv, cfg.head_dim)


def test_the_partial_softmax_combine_is_the_softmax():
    """Slices of the keys scored apart and combined in order give the
    one-pass attention (a slice with every key masked weighs nothing)."""
    from repro_torch.kernels.paged_attention import paged_attention_ref
    from repro_torch.models import layers

    g = torch.Generator().manual_seed(0)
    b, s, h, kv, d, t, n = 2, 3, 4, 2, 16, 12, 3
    q = torch.randn((b, s, h, d), generator=g)
    k = torch.randn((b, t, kv, d), generator=g)
    v = torch.randn((b, t, kv, d), generator=g)
    qpos = torch.tensor([[0, 1, 2], [5, 6, 7]], dtype=torch.int32)
    want = paged_attention_ref(q, k, v, torch.arange(b, dtype=torch.int32)[:, None], qpos)
    tl = t // n
    parts = [layers.partial_attention(q, k[:, i * tl:(i + 1) * tl], v[:, i * tl:(i + 1) * tl],
                                      qpos, i * tl) for i in range(n)]
    m, sm, o = (torch.stack([p[j] for p in parts]) for j in range(3))
    top = m.amax(0)
    w = torch.exp(m - top)
    got = (o * w[..., None]).sum(0) / (sm * w).sum(0)[..., None]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
