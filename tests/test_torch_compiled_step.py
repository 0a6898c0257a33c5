"""The compiled-step slice: what a captured CUDA graph needs of the port's
steps, held on the CPU.

  * Adam's multi-tensor update against the leaf-by-leaf update it
    replaced (kept here as the reference) bit for bit, and against
    ``repro.optim.adam``;
  * the static paged write (invalid tokens into a sink page) against the
    ``nonzero`` write, page for page; the engine's static step against its
    eager one and the sampled rows' tokens against the form that drew only
    them;
  * the 1x1 convs' strided patches and col2im against ``F.unfold`` /
    ``F.fold``;
  * the census's host syncs of the reduced dense slot step and both CNN
    train steps: none;
  * ``launch/graphs.py::StepGraphs``: the CPU route, and the launch
    bookkeeping of a capture with a stub graph;
  * the CNN CLIs' in-place step against the functional ``train_step``,
    and the sampler's captured step against the loop it replaced.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.optim import adam as jadam
from repro_torch.analysis import dispatch_walk
from repro_torch.configs.registry import get_config
from repro_torch.core.policy import tpu_default
from repro_torch.data.pipeline import ImagePipeline, ImagePipelineConfig
from repro_torch.kernels import gathered_matmul as gm
from repro_torch.kernels import im2col
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch import graphs
from repro_torch.launch import steps
from repro_torch.launch import train_classifier as tc
from repro_torch.launch import train_ddpm as td
from repro_torch.models import ddpm
from repro_torch.models import layers
from repro_torch.models import model as tlm
from repro_torch.models import resnet
from repro_torch.optim import adam
from repro_torch.serve.engine import ContinuousBatchingEngine
from repro_torch.serve.request import Request, SamplingParams
from repro_torch.serve.scheduler import ServeConfig
from torch_adam_ref import per_leaf_updates

# --- Adam --------------------------------------------------------------


def _tree(rng, dtype):
    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)

    # a norm-like fp32 leaf beside the working-dtype ones, as the LM has
    return {"w": t(6, 5), "blocks": [{"k": t(3, 3, 2), "b": t(7)}, {"k": t(4, 2)}],
            "norm": t(5).float()}


def _bits(leaves):
    return [t.view(torch.int16 if t.element_size() == 2 else torch.int32) for t in leaves]


ADAM_CFGS = {
    "adam": adam.AdamConfig(lr=1e-2),
    "adamw-clip-cosine": adam.AdamConfig(lr=3e-3, weight_decay=1e-2, clip_norm=0.5,
                                          schedule="warmup_cosine", warmup_steps=1,
                                          total_steps=6),
}


# one group; a leaf or two a group; the leaves of 20 (10) elements or more
# alone, the last (a middle one) among them
@pytest.mark.parametrize("groups,alone", [(1 << 26, 1 << 22), (9, 1 << 22), (1 << 26, 20),
                                          (1 << 26, 10)])
@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cfg", list(ADAM_CFGS))
def test_multi_tensor_adam_equals_per_leaf(cfg, dtype, inplace, groups, alone, monkeypatch):
    """Four steps: params, moments and the step count bit for bit, the
    grads' in-place clip too."""
    monkeypatch.setattr(adam, "GROUP_ELEMS", groups)
    monkeypatch.setattr(adam, "ALONE_ELEMS", alone)
    ocfg = ADAM_CFGS[cfg]
    rng = np.random.default_rng(7)
    params = _tree(rng, dtype)
    ref = adam.tree_map(torch.clone, params)
    state, ref_state = adam.init(params), adam.init(ref)
    for step in range(4):
        grads = adam.tree_map(lambda t: t * (step + 1), _tree(rng, dtype))
        ref_grads = adam.tree_map(torch.clone, grads)
        params, state, _ = adam.apply_updates(ocfg, params, grads, state, inplace=inplace)
        ref, ref_state = per_leaf_updates(ocfg, ref, ref_grads, ref_state, inplace=inplace)
        if inplace:
            assert all(torch.equal(a, b) for a, b in zip(
                _bits(adam.tree_leaves(grads)), _bits(adam.tree_leaves(ref_grads)), strict=True))
    ours = adam.tree_leaves((params, state.m, state.v))
    theirs = adam.tree_leaves((ref, ref_state.m, ref_state.v))
    assert [t.dtype for t in ours] == [t.dtype for t in theirs]
    for a, b in zip(_bits(ours), _bits(theirs), strict=True):
        assert torch.equal(a, b)
    assert int(state.step) == int(ref_state.step) == 4
    assert list(params) == ["w", "blocks", "norm"]  # the tree keeps its key order


@pytest.mark.parametrize("cfg", list(ADAM_CFGS))
def test_multi_tensor_adam_matches_jax(cfg, monkeypatch):
    """The JAX package's update within the existing Adam tests' tolerance,
    over leaves split across groups."""
    monkeypatch.setattr(adam, "GROUP_ELEMS", 16)
    rng = np.random.default_rng(3)
    tree = adam.tree_map(lambda t: t.numpy(), _tree(rng, torch.float32))
    pj = jax.tree.map(jnp.asarray, tree)
    pt = adam.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)
    cj = jadam.AdamConfig(**dataclasses.asdict(ADAM_CFGS[cfg]))
    oj, ot = jadam.init(pj), adam.init(pt)
    for step in range(4):
        g = jax.tree.map(
            lambda a: (rng.standard_normal(a.shape) * (step + 1)).astype(np.float32), tree)
        pj, oj, _ = jadam.apply_updates(cj, pj, jax.tree.map(jnp.asarray, g), oj)
        pt, ot, _ = adam.apply_updates(ADAM_CFGS[cfg], pt, adam.tree_map(torch.from_numpy, g), ot)
    for a, b in zip(adam.tree_leaves((pt, ot.m, ot.v)), jax.tree.leaves((pj, oj.m, oj.v)),
                    strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)


def test_adam_groups_cover_every_leaf_once(monkeypatch):
    assert adam._groups([]) == []
    sizes = [5, 30, 3, 3, 70, 1]
    for alone in (1 << 22, 30, 4):
        monkeypatch.setattr(adam, "ALONE_ELEMS", alone)
        for limit in (1, 8, 10, 40, 1000):
            monkeypatch.setattr(adam, "GROUP_ELEMS", limit)
            got = adam._groups(sizes)
            assert sorted(i for g in got for i in g) == list(range(len(sizes)))
            assert all(len(g) == 1 or sum(sizes[i] for i in g) <= limit for g in got)
            assert all(len(g) == 1 for g in got if any(sizes[i] >= alone for i in g))


# --- the static paged write --------------------------------------------


def _nonzero_write(block_tables, positions, valid, bs, sink=None):
    """The write index the sink replaced: the valid tokens picked on the host."""
    logical = positions.long()
    blk = torch.clamp(logical // bs, 0, block_tables.shape[1] - 1)
    page = torch.gather(block_tables.long(), 1, blk)
    rows, cols = valid.nonzero(as_tuple=True)
    return rows, cols, (page[rows, cols], (logical % bs)[rows, cols])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sink_write_leaves_every_real_page_as_the_nonzero_write(dtype):
    """Idle slots, partial chunks, unassigned table entries (page 0): the
    n real pages after the static write equal the nonzero write's bit for
    bit; the sink takes only invalid tokens."""
    rng = np.random.default_rng(11)
    b, s, bs, nb, n, kv, d = 4, 6, 4, 5, 20, 2, 8
    tables = np.zeros((b, nb), np.int32)
    pages = rng.permutation(n)
    tables[0, :3], tables[1, :5], tables[2, :2] = pages[:3], pages[3:8], pages[8:10]
    pos = torch.tensor([1, 9, 3, 0])
    count = torch.tensor([6, 1, 4, 0])
    positions = pos[:, None] + torch.arange(s)[None, :]
    valid = torch.arange(s)[None, :] < count[:, None]
    new = torch.from_numpy(rng.standard_normal((b, s, kv, d)).astype(np.float32))
    pool = torch.from_numpy(rng.standard_normal((n + 1, bs, kv, d)).astype(np.float32)).to(dtype)
    ref = pool[:n].clone()
    rows, cols, dest = _nonzero_write(torch.from_numpy(tables), positions, valid, bs)
    ref[dest] = new[rows, cols].to(dtype)
    rows, cols, dest = layers.paged_write_index(torch.from_numpy(tables), positions, valid, bs,
                                                n)
    assert rows == cols == slice(None) and dest[0].shape == (b, s)
    assert set(dest[0][~valid].tolist()) == {n}
    assert not (dest[0][valid] == n).any()
    pool[dest] = new[rows, cols].to(dtype)
    assert torch.equal(_bits([pool[:n]])[0], _bits([ref])[0])


@pytest.fixture(scope="module")
def dense_model():
    cfg = get_config("qwen2.5-3b").reduced()
    return cfg, tlm.init_params(cfg, 0, device="cpu")


def test_decode_slots_sink_write_equals_the_nonzero_write(dense_model, monkeypatch):
    """Two mixed steps of the reduced qwen2.5-3b on the kernel route: the
    logits and every real page equal the nonzero write's bit for bit, and
    the sink is the pool's last page."""
    cfg, params = dense_model
    b, c, bs, nb = 4, 6, 4, 4
    n = b * nb
    rng = np.random.default_rng(2)
    tables = torch.from_numpy(rng.permutation(n).reshape(b, nb).astype(np.int32))
    caches = [tlm.init_paged_cache(cfg, n, bs, torch.float32, "cpu") for _ in range(2)]
    assert all(layer["k"].shape[0] == n + 1 for layer in caches[0])
    pos = torch.tensor([0, 5, 9, 3], dtype=torch.int32)
    for width, count in ((c, [6, 4, 1, 0]), (1, [1, 1, 1, 0])):
        count = torch.tensor(count, dtype=torch.int32)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, width)).astype(np.int32))
        la, caches[0] = tlm.decode_slots(cfg, params, toks, caches[0], pos, count,
                                         block_tables=tables)
        with monkeypatch.context() as m:
            m.setattr(layers, "paged_write_index", _nonzero_write)
            lb, caches[1] = tlm.decode_slots(cfg, params, toks, caches[1], pos, count,
                                             block_tables=tables)
        assert torch.equal(la[count > 0], lb[count > 0])
        pos = pos + count
    for la, lb in zip(*caches, strict=True):
        for k in ("k", "v"):
            assert torch.equal(la[k][:n], lb[k][:n])
            assert la[k][n].any() and not lb[k][n].any()  # idle tokens went to the sink


def _old_emit(logits, state, fold):
    """The emit the static one replaced: only the sampled rows drawn."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if "rng" not in state:
        return greedy
    rows = torch.nonzero(state["temps"] > 0)[:, 0]
    if not len(rows):
        return greedy
    sampled = steps.sample_tokens(logits[rows], fold=fold[rows],
                                  **{k: state[k][rows] for k in steps._CONTROLS})
    return greedy.index_copy(0, rows, sampled)


@pytest.mark.parametrize("greedy_rows", [(), (0, 3, 4), (0, 1, 2, 3, 4, 5)])
def test_static_emit_equals_the_sampled_rows_draw(greedy_rows):
    rng = np.random.default_rng(len(greedy_rows))
    b, v = 6, 96
    logits = torch.from_numpy((rng.standard_normal((b, v)) * 3).astype(np.float32))
    temps = torch.full((b,), 0.8)
    temps[list(greedy_rows)] = 0.0
    state = {"temps": temps, "top_ks": torch.full((b,), 20, dtype=torch.int64),
             "top_ps": torch.full((b,), 0.9),
             "rng": torch.from_numpy(rng.integers(0, 2**32, (b, 2)).astype(np.int64))}
    fold = torch.from_numpy(rng.integers(-1, 400, b))  # an idle row folds at -1
    assert torch.equal(steps._emit_tokens(logits, state, fold), _old_emit(logits, state, fold))
    assert torch.equal(steps._emit_tokens(logits, {}, fold), _old_emit(logits, {}, fold))


def _engine_run(cfg, params, graphs_on, **skw):
    eng = ContinuousBatchingEngine(
        cfg, params, ServeConfig(max_slots=3, max_seq=40, prefill_chunk=4, block_size=4, **skw),
        device="cpu", graphs=graphs_on)
    rng = np.random.default_rng(4)
    for rid in range(5):
        sp = SamplingParams(0.9, 30, 0.95, seed=rid) if rid % 2 else None
        eng.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab, 5 + rid),
                           max_new_tokens=6 + rid, arrival=rid // 2,
                           **({"sampling": sp} if sp else {})))
    return eng, eng.run()


@pytest.mark.parametrize("skw", [{}, {"n_blocks": 9, "preempt": "swap"}])
def test_engine_static_step_equals_eager(dense_model, skw):
    """Greedy and sampled requests (and swaps): the step through the
    graphs' helper (its eager route here) gives the eager step's streams
    and counters, and every real page ends zero."""
    cfg, params = dense_model
    a, sa = _engine_run(cfg, params, True, **skw)
    b, sb = _engine_run(cfg, params, False, **skw)
    assert a._static and not b._static and not a.captured
    assert {r: t.tolist() for r, t in sa.items()} == {r: t.tolist() for r, t in sb.items()}
    assert a.stats()["preemptions"] == b.stats()["preemptions"]
    assert all(layer["k"].shape[0] == a.slots.n_blocks + 1 and not layer["k"].any()
               for layer in a.slots.cache)  # the sink zeroed with the freed pages
    assert a.graph_stats() == {"captured": False, "keys": [], "replays": 0, "capture_s": 0.0,
                               "pool_bytes": 0}


def test_engine_keeps_the_other_modes_eager(dense_model):
    cfg, params = dense_model
    for kw in ({"spec_k": 2, "block_size": 4}, {"block_size": 0}):
        eng = ContinuousBatchingEngine(cfg, params, ServeConfig(max_slots=2, max_seq=32, **kw),
                                       device="cpu")
        assert not eng._static
    moe = get_config("kimi-k2-1t-a32b").reduced()
    eng = ContinuousBatchingEngine(moe, tlm.init_params(moe, 0, device="cpu"),
                                   ServeConfig(max_slots=2, max_seq=32, block_size=4),
                                   device="cpu")
    assert not eng._static


# --- 1x1 convs without unfold --------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride,padding,hw", [
    ((2, 2), ((0, 0), (0, 0)), (8, 8)),
    ((2, 2), ((0, 0), (0, 0)), (7, 9)),
    ((1, 1), ((0, 0), (0, 0)), (5, 6)),
    ((2, 1), ((1, 0), (0, 1)), (6, 5)),
])
def test_pointwise_patches_equal_unfold_and_fold(stride, padding, hw, dtype):
    """``x2`` equals ``F.unfold``'s rows and ``col2im`` ``F.fold``'s
    image bit for bit, a ``-0.0`` cotangent included (fold adds into
    zeros, which makes it ``+0.0``)."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 3, *hw)).astype(np.float32)).to(dtype)
    x2, col2im, (ho, wo) = im2col.conv_patches(x, 1, 1, stride, padding, (1, 1))
    (ph0, ph1), (pw0, pw1) = padding
    xp = F.pad(x, (pw0, pw1, ph0, ph1))
    p = F.unfold(xp, (1, 1), stride=stride)
    assert torch.equal(x2, p.transpose(1, 2).reshape(-1, 3)) and x2.is_contiguous()
    d2 = torch.from_numpy(rng.standard_normal(tuple(x2.shape)).astype(np.float32))
    d2[0, 0], d2[1, 2] = -0.0, -0.0
    dcol = d2.reshape(2, ho * wo, 3).transpose(1, 2).to(dtype)
    ref = F.fold(dcol.float(), xp.shape[2:], (1, 1), stride=stride)
    ref = ref[:, :, ph0:ph0 + hw[0], pw0:pw0 + hw[1]].to(dtype)
    assert torch.equal(_bits([col2im(d2)])[0], _bits([ref])[0])


# --- host syncs: none in a captured step ---------------------------------


def _census_syncs(fn, args) -> list[str]:
    meta = dispatch_walk.meta_like(args)
    with dispatch_walk.Census(args=meta) as c:
        out = fn(*meta)
    return [s.op for s in c.finish(out).syncs]


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel", "gather"])
@pytest.mark.parametrize("sampled", [False, True])
def test_census_dense_slot_step_has_no_host_sync(dense_model, sampled, kernel, monkeypatch):
    cfg, params = dense_model
    b, w, bs, n = 3, 4, 4, 12
    cache = tlm.init_paged_cache(cfg, n, bs, torch.float32, "cpu")
    state = {"tokens": torch.zeros((b, w), dtype=torch.int32),
             "count": torch.tensor([4, 1, 0], dtype=torch.int32),
             "pos": torch.tensor([0, 7, 0], dtype=torch.int32), "cache": cache,
             "block_tables": torch.zeros((b, 4), dtype=torch.int32)}
    if sampled:
        state.update(steps.sampling_state([SamplingParams(0.7, 10, 0.9, seed=1), None, None],
                                          "cpu"))
    fn = steps.make_slot_step(cfg, paged_kernel=kernel)
    assert _census_syncs(lambda p, s: fn(p, s)[0], (params, state)) == []
    # the census sees the host read of the write the sink replaced
    monkeypatch.setattr(layers, "paged_write_index", _nonzero_write)
    assert "nonzero" in _census_syncs(lambda p, s: fn(p, s)[0], (params, state))


CNN_POLICY = dataclasses.replace(tpu_default(0.8), block_size=4, use_pallas=True)


def _cnn_case(kind):
    """A small CNN training step's (params, Adam state, batch, loss_of,
    Adam config), on the CPU."""
    if kind == "resnet18":
        params = resnet.init_params("resnet18", 0, 10, device="cpu")
        batch = (torch.zeros((4, 3, 16, 16)), torch.zeros((4,), dtype=torch.long))
        return params, adam.init(params), batch, (
            lambda p, pol, x, y: tc.loss_fn("resnet18", p, x, y, pol)), adam.AdamConfig()
    params = ddpm.init_params(0, channels=3, base=8, t_dim=32, device="cpu")
    sched = dispatch_walk.meta_like(ddpm.make_schedule(20, device="cpu"))
    x0 = torch.zeros((2, 3, 16, 16))
    return params, adam.init(params), (x0, torch.zeros((2,), dtype=torch.long), x0), (
        lambda p, pol, x0, t, nz: ddpm.loss_fn(p, sched, x0, t, nz, pol)), adam.adamw()


@pytest.mark.parametrize("kind", ["resnet18", "ddpm"])
def test_census_cnn_train_steps_have_no_host_sync(kind):
    """The in-place step the CLIs capture, sparse on the kernel route, on
    ``meta``: no host sync, the fused kernels launched."""
    params, opt, batch, loss_of, ocfg = _cnn_case(kind)
    meta = dispatch_walk.meta_like((params, opt, batch))
    step = steps.make_inplace_step(loss_of, meta[0], meta[1], ocfg, lambda _: CNN_POLICY)
    with dispatch_walk.Census(args=meta) as c:
        out = step(0.8, *meta[2])
    counts = c.finish(out)
    assert [s.op for s in counts.syncs] == []
    assert counts.launches_by_name().get("conv_dw_fused", 0) > 0


def test_census_sampler_step_has_no_host_sync():
    """The sampler's denoising step (the graph replayed ``T`` times): its
    timestep a device tensor, no host sync."""
    params = ddpm.init_params(0, channels=3, base=8, t_dim=32, device="cpu")
    sched = ddpm.make_schedule(20, device="cpu")
    x = torch.zeros((2, 3, 16, 16))
    args = (params, sched, x, torch.tensor(7), x)
    assert _census_syncs(lambda *a: ddpm.denoise_step(*a), args) == []


# --- the capture helper ----------------------------------------------------


def test_step_graphs_cpu_route_runs_eagerly():
    calls = []

    def fn(key, x):
        calls.append(key)
        return x * 2

    sg = graphs.StepGraphs(fn, "cpu")
    for k in ("a", "a", "b"):
        assert torch.equal(sg(k, torch.ones(3)), torch.full((3,), 2.0))
    assert calls == ["a", "a", "b"] and not sg.captured and sg.graphs == {}


class _StubGraph:
    def __init__(self, fn, args, log):
        self.fn, self.args, self.log = fn, args, log

    def replay(self):  # what a replay computes, without entering a wrapper
        self.log.append("replay")
        with torch.no_grad():
            self.out_ref.copy_(self.args[0] * 3)


class _StubBackend:
    """Captures by running the step's Python once (the wrappers count as a
    capture would make them), replays without it."""

    def __init__(self):
        self.log = []

    def run_eager(self, fn, args):
        self.log.append("eager")
        return fn(*args)

    def capture(self, fn, args):
        self.log.append("capture")
        out = fn(*args)
        g = _StubGraph(fn, args, self.log)
        g.out_ref = out
        return g, out

    def reserved(self):
        return 0

    def staging(self, t):
        return torch.empty_like(t)


def test_step_graphs_launch_bookkeeping():
    """Each call of the step enters two wrappers (2 ``dx_gathered``, 1
    ``paged_attention``). The first call counts its real launches, the
    capture's are taken back, and every replay adds them again; replays
    read the new inputs through the static buffers."""
    def fn(key, x):
        gm.launches["dx_gathered"] += 2
        pa.launches += 1
        return x * 3

    before = graphs.launch_counts()
    backend = _StubBackend()
    sg = graphs.StepGraphs(fn, "cpu", backend=backend)
    assert sg.captured
    out = sg("k", torch.ones(4))
    assert torch.equal(out, torch.full((4,), 3.0))
    g = sg.graphs["k"]
    assert g.launches == {"dx_gathered": 2, "paged_attention": 1}
    after = graphs.launch_counts()
    assert after["dx_gathered"] - before["dx_gathered"] == 2
    assert after["paged_attention"] - before["paged_attention"] == 1
    for i in range(3):
        got = sg("k", torch.full((4,), float(i)))
        assert got is g.out and torch.equal(got, torch.full((4,), 3.0 * i))
    after = graphs.launch_counts()
    assert after["dx_gathered"] - before["dx_gathered"] == 2 * 4
    assert after["paged_attention"] - before["paged_attention"] == 4
    assert backend.log == ["eager", "capture", "replay", "replay", "replay"]
    assert sg.stats()["replays"] == 3 and sg.stats()["keys"] == ["'k'"]
    with pytest.raises(ValueError):
        sg("k", torch.ones(5))


# --- the CLIs' in-place steps and the sampler ------------------------------


def test_classifier_cli_step_equals_functional_train_step():
    """The CLI's in-place step (what the card captures) against a loop of
    the functional ``train_step``: losses, kept channels, params and Adam
    state bit for bit, dense and sparse steps."""
    argv = ["--device", "cpu", "--batch", "4", "--image-size", "8", "--steps", "4",
            "--steps-per-epoch", "1", "--granularity", "block", "--block-size", "32",
            "--use-pallas", "--mode", "ssprop"]
    args = tc.build_parser().parse_args(argv)
    out = tc.run(args)
    rec = out["modes"]["ssprop"]
    assert out["captured"] is False
    pipe = ImagePipeline(ImagePipelineConfig((3, 8, 8), 10, 4, seed=11), n_train=1024)
    params = resnet.init_params("resnet18", 0, 10, device="cpu")
    opt = adam.init(params)
    from repro_torch.core import backward

    for i, rate in enumerate(rec["rates"]):
        b = pipe.batch_at(i)
        with backward.record_selections() as log:
            params, opt, loss = tc.train_step(
                "resnet18", params, opt, torch.from_numpy(b["images"]),
                torch.from_numpy(b["labels"]).long(), tc.step_policy(args, rate),
                adam.AdamConfig(lr=args.lr))
        assert loss.item() == rec["losses"][i]
        np.testing.assert_array_equal(steps.kept_channels(log, "cpu").numpy(), rec["kept"][i])
    assert [len(k) > 0 for k in rec["kept"]] == [r > 0 for r in rec["rates"]]
    cli_params, cli_opt = rec["state"]
    for a, b in zip(adam.tree_leaves((cli_params, cli_opt.m, cli_opt.v)),
                    adam.tree_leaves((params, opt.m, opt.v)), strict=True):
        assert torch.equal(a, b)
    assert int(cli_opt.step) == int(opt.step) == 4


def test_ddpm_cli_step_and_sampler_equal_the_eager_loops():
    """The DDPM CLI's in-place step against the functional one (losses
    and final state bit for bit), and the sampler's one-step graph body
    against the loop it replaced."""
    argv = ["--device", "cpu", "--channels", "3", "--size", "8", "--timesteps", "6", "--base",
            "8", "--t-dim", "16", "--batch", "2", "--steps", "2", "--steps-per-epoch", "1",
            "--granularity", "block", "--block-size", "4", "--use-pallas", "--mode", "ssprop",
            "--out", ""]
    args = td.build_parser().parse_args(argv)
    out = td.run(args)
    rec = out["modes"]["ssprop"]
    pipe = ImagePipeline(ImagePipelineConfig((3, 8, 8), 10, 2, seed=11), n_train=1024)
    sched = ddpm.make_schedule(6, device="cpu")
    params = ddpm.init_params(0, channels=3, base=8, t_dim=16, device="cpu")
    opt = adam.init(params)
    gen = torch.Generator().manual_seed(1)
    for i, rate in enumerate(rec["rates"]):
        x0 = torch.from_numpy(pipe.batch_at(i)["images"])
        t, noise = ddpm.draw_t_noise(gen, x0, 6)
        params, opt, loss = td.train_step(params, opt, sched, x0, t, noise,
                                          td.step_policy(args, rate), adam.adamw())
        assert loss.item() == rec["losses"][i]
    for a, b in zip(adam.tree_leaves(rec["state"][0]), adam.tree_leaves(params), strict=True):
        assert torch.equal(a, b)
    # the sampler: the loop with a Python timestep, fed the same noise
    gen = torch.Generator().manual_seed(42)
    x_t = torch.randn((4, 3, 8, 8), generator=gen)
    zs = [torch.randn((4, 3, 8, 8), generator=gen) for _ in range(6)]
    x = x_t
    with torch.no_grad():
        for i in range(6):
            tt = 5 - i
            eps = ddpm.forward(params, x, torch.full((4,), tt, dtype=torch.long))
            alpha, acp = sched["alphas"][tt], sched["acp"][tt]
            mean = (x - (1 - alpha) / torch.sqrt(1 - acp) * eps) / torch.sqrt(alpha)
            x = mean + torch.sqrt(sched["betas"][tt]) * (zs[i] if tt > 0 else torch.zeros_like(x))
    got = ddpm.sample(params, sched, x_t, lambda i: zs[i])
    assert torch.equal(got, x)
    assert np.isfinite(out["samples"]).all() and out["samples"].shape == (4, 3, 8, 8)

