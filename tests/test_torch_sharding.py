"""The port's partition-spec rules and mesh-shaped checkpoint plans
against the JAX package's.

``fit_spec`` on every case of ``tests/test_dist.py``'s ``TestFitSpec``;
``param_specs`` (with and without ``replicate_kv``) over the port's
params in the JAX layout (``models/model.py::jax_layout``) for every
registry arch, reduced, leaf for leaf against ``repro.dist.sharding`` on
the JAX package's abstract params, raw and repaired on three meshes; the
batch, cache (contiguous and paged, ``seq_shard``) and swap specs on a
JAX ``AbstractMesh``'s shardings; ``plan_from_specs`` piece for piece on
meshes (2,4), (4,2) and (2,2,2) over 2 and 4 hosts; and a sharded save
under such a plan that each package restores from the other's bit for
bit. The mesh helpers of ``launch/mesh.py`` against the reference's.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs.registry import get_config as jget
from repro.dist import sharding as jshd
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models import model as jlm
from repro_torch.checkpoint import ckpt
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.configs.registry import get_config as tget
from repro_torch.dist import sharding as shd
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model as tlm


class FakeMesh:  # tests/test_dist.py's
    def __init__(self, **shape):
        self.shape = shape


# --- fit_spec: tests/test_dist.py::TestFitSpec, case for case -----------

FIT_CASES = [
    (dict(model=4, data=2), ("data", None, "model"), (8, 3, 16), ("data", None, "model")),
    (dict(model=16), (None, "model", None), (32, 8, 32), (None, None, "model")),
    (dict(model=16), (None, "model", None), (32, 8, 3), ("model", None, None)),
    (dict(model=16), ("model", None), (3, 5), (None, None)),
    (dict(pod=2, data=16), (("pod", "data"), None), (8, 64), ("pod", "data")),
    (dict(pod=2, data=16, model=4), (("pod", "data"), None), (16, 4096), ("data", "pod")),
    (dict(pod=2, data=16, model=4), (("pod", "data"), None), (1, 524288), (None, "pod")),
    (dict(pod=2, data=16), (("pod", "data"), None), (64, 64), (("pod", "data"), None)),
    (dict(data=2), ("data",), (4, 8, 3), ("data", None, None)),
    (dict(model=4), (None, None, "model"), (8, 16), (None, None)),
    (dict(model=1), ("model", None), (3, 5), ("model", None)),
]


@pytest.mark.parametrize("mesh,spec,shape,want", FIT_CASES)
def test_fit_spec_matches_test_dist(mesh, spec, shape, want):
    got = shd.fit_spec(shd.Spec(*spec), shape, mesh)
    assert isinstance(got, shd.Spec) and tuple(got) == want
    assert shd.fit_spec(spec, shape, FakeMesh(**mesh)) == got  # a mesh-like object too
    assert tuple(jshd.fit_spec(P(*spec), shape, FakeMesh(**mesh))) == want


# --- param_specs over the JAX layout ------------------------------------

MESHES = [dict(data=2, model=4), dict(data=16, model=16), dict(pod=2, data=16, model=16)]
_PARAMS = {}


def _port_items(arch):
    """``[(keystr, leaf)]`` of the port's reduced params in the JAX layout
    (stacked leaves as the checkpoint's shape-only ``Stacked``)."""
    if arch not in _PARAMS:
        cfg = tget(arch).reduced()
        tree = tlm.jax_layout(cfg, tlm.init_params(cfg, 0, device="cpu"), ckpt.Stacked)
        _PARAMS[arch] = tree
    return _PARAMS[arch]


def _spec_items(tree, path=""):
    """``[(keystr, Spec)]`` of a spec tree in the checkpoint's key order (a
    ``Spec`` is a tuple, so it must not be walked into)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_items(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _spec_items(v, f"{path}[{i}]")]
    return [(path, tree)]


def _flat(tree, is_leaf=None):
    return {jax.tree_util.keystr(k): v
            for k, v in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


@pytest.mark.parametrize("replicate_kv", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_jax(arch, replicate_kv):
    tree = _port_items(arch)
    a_params, _ = jsteps.abstract_state(jget(arch).reduced())
    jspecs = _flat(jshd.param_specs(a_params, replicate_kv=replicate_kv),
                   is_leaf=lambda x: isinstance(x, P))
    shapes = _flat(a_params)
    items, _ = ckpt._flatten(tree)
    tspecs = dict(_spec_items(shd.param_specs(tree, replicate_kv=replicate_kv)))
    assert sorted(tspecs) == sorted(jspecs) == sorted(k for k, _ in items)
    for key, leaf in items:
        assert tuple(leaf.shape) == tuple(shapes[key].shape), key
        assert tuple(tspecs[key]) == tuple(jspecs[key]), key
        for mesh in MESHES:
            assert tuple(shd.fit_spec(tspecs[key], leaf.shape, mesh)) == \
                tuple(jshd.fit_spec(jspecs[key], leaf.shape, FakeMesh(**mesh))), (key, mesh)
    assert any("model" in tuple(s) for s in tspecs.values())


# --- batch, cache and swap specs ----------------------------------------


def _shapes(tree):
    """The tree with each leaf a shape-only stand-in (dicts and lists kept)."""
    return jax.tree.map(lambda a: types.SimpleNamespace(shape=tuple(a.shape)), tree)


def _jspecs(shardings):
    return [tuple(s.spec) for s in jax.tree.leaves(
        shardings, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))]


def _tspecs(specs):
    return [tuple(s) for s in jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, shd.Spec))]


def _abstract(mesh):
    return jax.sharding.AbstractMesh(tuple(mesh.values()), tuple(mesh))


@pytest.mark.parametrize("mesh", MESHES + [dict(data=4, model=2)], ids=str)
def test_batch_specs_match_jax(mesh):
    batch = {"tokens": jax.ShapeDtypeStruct((8, 64), jnp.int32),
             "frames": jax.ShapeDtypeStruct((8, 30, 16), jnp.float32),
             "one": jax.ShapeDtypeStruct((1, 3), jnp.float32),
             "step": jax.ShapeDtypeStruct((), jnp.int32)}
    got = _tspecs(shd.batch_specs(mesh, _shapes(batch)))
    assert got == _jspecs(jshd.batch_shardings(_abstract(mesh), batch))
    assert shd.block_table_spec() == shd.Spec() == shd.replicated()


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-1.3b", "jamba-1.5-large-398b",
                                  "whisper-large-v3"])
@pytest.mark.parametrize("mesh", [dict(data=2, model=4), dict(pod=2, data=2, model=2)], ids=str)
def test_cache_and_swap_specs_match_jax(arch, mesh):
    cfg = jget(arch).reduced()
    am = _abstract(mesh)
    contiguous = jax.eval_shape(lambda: jlm.init_cache(cfg, 4, 32))
    paged = jax.eval_shape(lambda: jlm.init_paged_cache(cfg, 4, 12, 8))
    for a_cache, is_paged in ((contiguous, False), (paged, True)):
        for seq_shard in (False, True):
            got = _tspecs(shd.cache_specs(mesh, _shapes(a_cache), seq_shard=seq_shard,
                                          paged=is_paged))
            want = _jspecs(jshd.cache_shardings(am, a_cache, seq_shard=seq_shard, paged=is_paged))
            assert got == want, (is_paged, seq_shard)

    # one slot's swap bundle: 3 of the pool's pages, the slot dim of the
    # per-slot leaves removed
    def bundle(path, a):
        name = str(path[-1].key) if hasattr(path[-1], "key") else ""
        if name in ("k", "v") and a.ndim >= 5:
            return jax.ShapeDtypeStruct((a.shape[0], 3, *a.shape[2:]), a.dtype)
        return jax.ShapeDtypeStruct((a.shape[0], *a.shape[2:]), a.dtype)

    swapped = jax.tree_util.tree_map_with_path(bundle, paged)
    assert _tspecs(shd.swap_specs(mesh, _shapes(swapped))) == \
        _jspecs(jshd.swap_shardings(am, swapped))


def test_mesh_helpers_match_jax():
    for multi in (False, True):
        shape = tmesh.production_mesh_shape(multi_pod=multi)
        ref = dict(zip(("pod", "data", "model") if multi else ("data", "model"),
                       (2, 16, 16) if multi else (16, 16), strict=True))
        assert shape == ref and list(shape) == list(ref)
        fake = FakeMesh(**shape)
        fake.axis_names = tuple(shape)
        assert tmesh.dp_axes(shape) == jmesh.dp_axes(fake) == tmesh.dp_axes(fake)
        assert tmesh.dp_size(shape) == jmesh.dp_size(fake) == (32 if multi else 16)
    assert tmesh.dp_axes({"model": 4}) == () and tmesh.dp_size({"model": 4}) == 1


# --- plans from specs, and a save laid out by one -----------------------

PLAN_MESHES = [{"data": 2, "model": 4}, {"data": 4, "model": 2},
               {"pod": 2, "data": 2, "model": 2}]


def _plans(arch, mesh, ranks):
    tree = _port_items(arch)
    items, _ = ckpt._flatten(tree)
    tspecs = [s for _, s in _spec_items(shd.param_specs(tree))]
    a_params, _ = jsteps.abstract_state(jget(arch).reduced())
    jspec_tree = jshd.param_specs(a_params)
    j_items = [(jax.tree_util.keystr(k), v)
               for k, v in jax.tree_util.tree_flatten_with_path(a_params)[0]]
    jspecs = jax.tree.leaves(jspec_tree, is_leaf=lambda x: isinstance(x, P))
    tplan = ckpt.plan_from_specs(items, tspecs, mesh, ranks)
    jplan = jckpt.plan_from_specs(j_items, jspecs, mesh, ranks)
    return items, tplan, jplan


@pytest.mark.parametrize("ranks", [[0, 1], [0, 1, 2, 3]], ids=str)
@pytest.mark.parametrize("mesh", PLAN_MESHES, ids=str)
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "kimi-k2-1t-a32b"])
def test_plan_from_specs_matches_jax(arch, mesh, ranks):
    items, tplan, jplan = _plans(arch, mesh, ranks)
    assert {k: [(p.shard, p.index) for p in v] for k, v in tplan.items()} == \
        {k: [(p.shard, p.index) for p in v] for k, v in jplan.items()}
    ckpt.validate_plan(tplan, {k: v.shape for k, v in items})
    assert {p.shard for v in tplan.values() for p in v} == set(ranks)
    with pytest.raises(ValueError, match="not divisible"):
        ckpt.plan_from_specs(items, [shd.Spec()] * len(items), {"data": 3}, ranks)


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("mesh,ranks", [({"data": 2, "model": 4}, [0, 1]),
                                        ({"pod": 2, "data": 2, "model": 2}, [0, 1, 2, 3])],
                         ids=str)
def test_sharded_save_under_mesh_plan_crosses_both_ways(mesh, ranks, tmp_path):
    """The reduced qwen2.5-3b's params, each rank writing the pieces its
    devices hold on ``mesh``: the port's save restores in the JAX package
    bit for bit, the JAX package's in the port, and the shard files are
    byte-identical."""
    cfg = jget("qwen2.5-3b").reduced()
    tree = jax.tree.map(np.asarray, jlm.init_params(cfg, jax.random.PRNGKey(1)))
    ttree = jax.tree.map(_to_torch, tree)
    t_items, _ = ckpt._flatten(ttree)
    j_items = [(jax.tree_util.keystr(k), v)
               for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]]
    tplan = ckpt.plan_from_specs(
        t_items, [s for _, s in _spec_items(shd.param_specs(ttree))], mesh, ranks)
    jplan = jckpt.plan_from_specs(
        j_items, jax.tree.leaves(jshd.param_specs(tree), is_leaf=lambda x: isinstance(x, P)),
        mesh, ranks)
    for r in sorted(ranks, reverse=True):  # the leader last: its commit finds every shard
        ckpt.save_sharded(str(tmp_path / "t"), 3, ttree, rank=r, ranks=ranks, plan=tplan,
                          commit_timeout_s=5)
        jckpt.save_sharded(str(tmp_path / "j"), 3, tree, rank=r, ranks=ranks, plan=jplan,
                           commit_timeout_s=5)
    for r in ranks:
        name = f"step_00000003/shard_{r}.msgpack"
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    got = jax.tree.map(np.asarray, jckpt.restore(str(tmp_path / "t"), 3, tree))
    for (k, a), (_, b) in zip(_flat(got).items(), _flat(tree).items(), strict=True):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    back = ckpt.restore(str(tmp_path / "j"), 3, ckpt.like_of(ttree))

    def raw(t):
        return t.dtype, tuple(t.shape), ckpt._byte_view(t.contiguous()).tobytes()

    for (k, a), (_, b) in zip(ckpt._flatten(back)[0], t_items, strict=True):
        assert raw(a) == raw(b), k
