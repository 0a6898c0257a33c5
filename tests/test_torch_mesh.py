"""The port's device meshes on the CPU: placements, local shards and the
step's collectives, against the JAX package's specs and plain one-process
ops.

The mesh shapes of each size (1x2 and 2x1; 2x2 and 1x4) share one spawn
of gloo ranks (``launch/mesh.py::run_on_mesh``, one torch thread a rank,
a 120-s timeout) that runs all of those shapes' cases and returns every
rank's results to the test, which holds them to:

* the local shard of every reduced qwen2.5-3b leaf: the slice the JAX
  package's ``param_specs`` + ``fit_spec`` give this rank over the JAX
  layout (the index arithmetic every backend uses), each rank's
  checkpoint pieces (the JAX package's
  ``plan_from_specs``) its own block, and ``gather_tree`` the full leaf;
* each ``dist/parallel.py`` Function's forward and gradient against the
  plain op on the full tensors, the vocab-parallel cross-entropy against
  ``log_softmax`` within 1e-6;
* ``select_on_mesh`` against the one-device selection restricted to the
  rank's columns.

Then every combination the CLIs still refuse raises (no spawn), and each
command line they refused before every family ran on a mesh runs and
prints the one-device CLI's losses or tokens.
"""
import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import torch_mesh_ranks as ranks

from repro.checkpoint import ckpt as jckpt
from repro.configs.registry import get_config as jax_get_config
from repro.dist import sharding as jshd
from repro.models import model as jlm
from repro_torch.configs.registry import get_config
from repro_torch.core import policy as tpolicy
from repro_torch.core import sparsity
from repro_torch.dist import parallel
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import layers

ARCH = "qwen2.5-3b"
SHAPES = [(1, 2), (2, 1), (2, 2), (1, 4)]
TIMEOUT_S = 120


@pytest.fixture(scope="module")
def jax_tree():
    jcfg = jax_get_config(ARCH).reduced()
    return jax.tree.map(np.asarray, jlm.init_params(jcfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def runs(jax_tree):
    """``{shape: every rank's results}``, one spawn for the shapes of each size."""
    out = {}
    for world in sorted({d * m for d, m in SHAPES}):
        calls = {sh: (ranks.mesh_cases, (jax_tree,)) for sh in SHAPES if sh[0] * sh[1] == world}
        out.update(tmesh.run_on_mesh(ranks.on_shapes, *next(iter(calls)), "cpu", calls,
                                     timeout_s=TIMEOUT_S))
    return out


def _jax_named_specs(jax_tree, shape):
    """``name -> (fitted spec, full leaf)`` in the port's naming: the JAX
    package's ``param_specs`` over its layout, ``fit_spec`` against the
    mesh, a stacked leaf's spec without its stack dim for each layer."""
    sizes = SimpleNamespace(shape={"data": shape[0], "model": shape[1]})
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    flat_specs = {_keys(path): sp for path, sp in jax.tree_util.tree_flatten_with_path(
        jshd.param_specs(jax_tree), is_leaf=is_spec)[0]}
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax_tree)[0]:
        keys = _keys(path)
        fitted = tuple(jshd.fit_spec(flat_specs[keys], leaf.shape, sizes))
        fitted = fitted + (None,) * (leaf.ndim - len(fitted))
        if keys[0] == "stack":  # stack/slots/0/...: layer li is the slot's li-th
            for li in range(leaf.shape[0]):
                name = "stack/layers/" + str(li) + "/" + "/".join(str(k) for k in keys[3:])
                out[name] = (fitted[1:], np.asarray(leaf)[li])
        else:
            out["/".join(str(k) for k in keys)] = (fitted, np.asarray(leaf))
    return out


def _keys(path):
    return tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)


def _block(full, spec, coord, shape):
    sizes = {"data": shape[0], "model": shape[1]}
    at = {"data": coord[0], "model": coord[1]}
    idx = []
    for d, e in zip(full.shape, spec + (None,) * (full.ndim - len(spec)), strict=True):
        if e is None:
            idx.append(slice(None))
        else:
            n = d // sizes[e]
            idx.append(slice(at[e] * n, (at[e] + 1) * n))
    return full[tuple(idx)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_local_shards_follow_the_jax_specs(runs, jax_tree, shape):
    """Every leaf's spec is the JAX package's fitted spec, and every
    rank's local shard is that spec's block of the full leaf; the shards
    gather back to the full leaves."""
    want = _jax_named_specs(jax_tree, shape)
    for res in runs[shape]:
        assert res["gather_eq"]
        assert sorted(res["local"]) == sorted(want)
        for name, (spec, full) in want.items():
            assert res["specs"][name] == spec, name
            np.testing.assert_array_equal(res["local"][name], _block(full, spec, res["coord"],
                                                                     shape), err_msg=name)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_checkpoint_pieces_are_each_ranks_block(runs, jax_tree, shape):
    """The JAX package's ``plan_from_specs`` over the mesh's ranks (one
    device a host) gives each rank pieces that are blocks it holds: what
    a mesh save writes from its local shards."""
    want = _jax_named_specs(jax_tree, shape)
    sizes = {"data": shape[0], "model": shape[1]}
    by_rank = {res["rank"]: res for res in runs[shape]}
    items = [(name, full) for name, (_, full) in want.items()]
    specs = [jax.sharding.PartitionSpec(*spec) for spec, _ in want.values()]
    plan = jckpt.plan_from_specs(items, specs, sizes, list(range(shape[0] * shape[1])))
    for name, pieces in plan.items():
        covered = 0
        for p in pieces:
            block = want[name][1][tuple(slice(s, e) for s, e in p.index)]
            np.testing.assert_array_equal(by_rank[p.shard]["local"][name], block, err_msg=name)
            covered += block.size
        assert covered == want[name][1].size, name


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_collectives_match_the_plain_ops(runs, shape):
    """Each Function's forward and gradient equal the plain op's on the
    full tensors (fp64, exact but for the summation order); the
    vocab-parallel cross-entropy (fp32) is ``log_softmax``'s within 1e-6."""
    for res in runs[shape]:
        for name, err in res["functions"].items():
            tol = 1e-6 if name == "vocab_cross_entropy" else 1e-12
            assert err <= tol, (name, err)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_the_programs_instruments(runs, shape):
    """``parallel.counters`` counts each collective's call and the bytes
    a rank sends, timing only within ``timed_collectives``; and
    ``backward.record_cotangents`` hands back a named mesh site's output
    gradient (the rank's columns) and nothing for a site that did not
    run."""
    for res in runs[shape]:
        c = res["counters"]
        assert (c["calls"], c["bytes"]) == (2, 4 * 8 + 3 * 4)
        assert c["s"] > 0.0
        assert res["cotangents"] == {"probe": True}


def test_select_on_mesh_equals_select_on_the_full_gradient(runs):
    """Channel, block (32) and ``tp_shards = model`` selections of one dY
    whose rows the data ranks and whose columns the model ranks split:
    the model ranks' kept columns together are ``select``'s on the full dY
    (the spawned ranks draw it from the same seed as here), and a
    row-parallel site (replicated columns) keeps ``select``'s channels on
    every rank, the data ranks' importance averaged first."""
    g = torch.Generator().manual_seed(1)
    # replay ranks.mesh_cases' draws up to dY
    torch.randn(4, 8, generator=g, dtype=torch.float64)
    torch.randn(8, 12, generator=g, dtype=torch.float64)
    torch.randn(4, 12, generator=g, dtype=torch.float64)
    torch.randn(12, generator=g, dtype=torch.float64)
    torch.randn(16, 4, generator=g, dtype=torch.float64)
    torch.randint(0, 16, (3, 5), generator=g)
    torch.randn(3, 5, 4, generator=g, dtype=torch.float64)
    torch.randn(3, 5, 16, generator=g)
    torch.randint(0, 13, (3, 5), generator=g)
    torch.rand(3, 5, generator=g)
    dy = torch.randn(8, 256, generator=g) * torch.linspace(0.1, 3.0, 256)[
        torch.randperm(256, generator=g)]
    for shape, results in runs.items():
        m = shape[1]
        for name, pol in (("channel", tpolicy.paper_default(0.8)), ("block", dataclasses.replace(
                tpolicy.tpu_default(0.8), block_size=32)), ("tp", dataclasses.replace(
                tpolicy.paper_default(0.8), tp_shards=m))):
            want = sparsity.select(dy, pol, n_shards=sparsity.selection_shards(pol, 256))
            idx = want.idx if want.valid is None else want.idx[want.valid]
            union = sorted({i for res in results for i in res["select"][name][0]})
            assert union == sorted(set(idx.tolist())), (shape, name)
            for res in results:
                assert res["select"][name][2] == want.idx.tolist(), (shape, name)
                if name == "block":  # 256 / m columns are whole 32-blocks: the block kernels
                    assert res["select"][name][1], shape


# ----------------------------------------------------------------------
# what still raises, and what runs now
# ----------------------------------------------------------------------

# a short run of each command line that no longer raises
SHORT_TRAIN = ["--steps", "3", "--steps-per-epoch", "1", "--global-batch", "4", "--seq-len",
               "16", "--use-pallas", "--log-every", "100"]
SHORT_SERVE = ["--batch", "2", "--requests", "4", "--prompt-len", "12", "--gen", "8",
               "--prefill-chunk", "4", "--block-size", "4"]


@pytest.mark.parametrize("argv, what", [
    (["--model-mesh", "2", "--world-size", "2"], "fleet"),
    (["--model-mesh", "2", "--arch", "mamba2-1.3b"], "ssm family"),
    (["--data-mesh", "2", "--arch", "kimi-k2-1t-a32b"], "moe family"),
    (["--data-mesh", "2", "--arch", "whisper-large-v3"], "encdec family"),
    (["--model-mesh", "2", "--arch", "paligemma-3b"], "vlm family"),
    (["--model-mesh", "2", "--arch", "jamba-1.5-large-398b"], "hybrid family"),
    (["--data-mesh", "3"], "does not divide"),
])
def test_train_cli_refuses(argv, what):
    """Nothing of these is refused any more: ``--world-size 2`` on a model
    mesh (a fleet on a mesh, ``tests/test_torch_fleet_mesh.py``; without
    ``--coord-dir``, as in the reference, one mesh's run), every family on
    a mesh, and a global batch the data mesh does not divide (3 ranks at
    batch 4 of 16 tokens: ``data`` divides neither, so every rank steps the
    whole batch): the same command line (a short run of it) prints the
    one-device CLI's losses within 1e-5 (whisper's frames and paligemma's
    patches come from ``frontend_inputs``)."""
    args = ttrain.build_parser().parse_args(["--device", "cpu", "--reduced", *argv])
    assert ttrain._refuse_unported(args, ttrain._config(args)) is None
    one = ttrain.run(ttrain.build_parser().parse_args(
        ["--device", "cpu", "--reduced", *argv[2:], *SHORT_TRAIN]))["history"]  # no mesh flag
    got = ttrain.run(ttrain.build_parser().parse_args(
        ["--device", "cpu", "--reduced", *argv, *SHORT_TRAIN]), timeout_s=TIMEOUT_S)["history"]
    assert len(got) == len(one) == 3
    for a, b in zip(got, one, strict=True):
        assert abs(a - b) <= 1e-5 * abs(b), (what, got, one)


@pytest.mark.parametrize("argv, what", [
    (["--data-mesh", "2"], "--data-mesh"),
    (["--model-mesh", "4"], "KV heads"),
    (["--model-mesh", "2", "--engine", "lockstep"], "lock-step"),
    (["--model-mesh", "2", "--arch", "mamba2-1.3b"], "ssm family"),
])
def test_serve_cli_refuses(argv, what):
    """Nothing of these is refused any more: ``--data-mesh`` serving (the
    slots over ``data``, the page pool replicated), the lock-step engine
    on a mesh, a model mesh that does not divide the KV heads (reduced
    qwen2.5-3b's 2 at model 4: each rank caches the KV head its q head
    reads) and the SSM family serve: the same command line (a short run of
    it) prints the one-device CLI's tokens."""
    base = ["--device", "cpu", "--reduced", *argv]
    one = tserve.run(tserve.build_parser().parse_args(
        ["--device", "cpu", "--reduced", *argv[2:], *SHORT_SERVE]))["generated"]
    got = tserve.run(tserve.build_parser().parse_args(base + SHORT_SERVE), timeout_s=TIMEOUT_S)
    assert got["generated"].tolist() == one.tolist()


def test_seq_shard_decode_raises():
    from repro_torch.serve import ContinuousBatchingEngine, ServeConfig

    cfg = get_config(ARCH).reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 5"):
        ContinuousBatchingEngine(cfg, {}, ServeConfig(max_slots=1, max_seq=8), device="cpu",
                                 seq_shard=True)


def test_heads_the_model_mesh_does_not_divide_raise():
    """Nothing raises any more where the model size does not divide the q
    heads, or neither divides nor is a multiple of the KV heads: at 3,
    which divides none of reduced qwen2.5-3b's 128 q columns, ``fit_spec``
    drops the split and every rank runs every head; 6 q heads and 6 KV
    heads on 4 ranks give each rank 1.5 heads' columns and a span of the 2
    heads they touch, with those KV heads."""
    cfg = get_config(ARCH).reduced()

    def span(c, model, rank):
        mesh = tmesh.Mesh(1, model, rank, torch.device("cpu"), "gloo", None, None)
        return layers.mesh_head_span(c, mesh)

    for r in range(3):
        got = span(cfg, 3, r)
        assert (got.q, got.kv, got.cols, got.split) == ((0, 4), (0, 2), (0, 128), False)
    six = [span(dataclasses.replace(cfg, n_heads=6, n_kv_heads=6), 4, r) for r in range(4)]
    assert [s.q for s in six] == [(0, 2), (1, 3), (3, 5), (4, 6)]
    assert [s.kv for s in six] == [s.q for s in six]
    assert [s.cols for s in six] == [(0, 48), (16, 64), (0, 48), (16, 64)]


def test_a_mesh_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.run_on_mesh(ranks.mesh_cases, 1, 2, "cuda", {})


def test_the_backend_rule():
    """NCCL only where each rank has a card of its own; gloo on the CPU
    and where ranks share a card."""
    assert tmesh.backend_for(torch.device("cpu"), 4) == "gloo"
    n = torch.cuda.device_count()
    assert tmesh.backend_for(torch.device("cuda"), n + 1) == "gloo"
