"""The port's checkpoints against the JAX package's: one format, both ways.

The codec is held to ``msgpack`` byte for byte; the flattener's keys to
``jax.tree_util.keystr``; a checkpoint either package writes (monolithic
or sharded over ranks [0,1], [0,1,2,3] and [0,2,3]) restores in the other
bit for bit, fp32, bf16, int32 and 0-d leaves among them; the shard
plans and manifests equal JAX's on the reduced qwen2.5-3b and kimi-k2
trees, and so do the shard files' bytes. Then the crash-safety
contract: a torn step stays invisible, ``keep`` collects old steps, a
restore that needs a missing shard raises ``MissingShardError``, a
partial restore opens only the shards it needs, a save's snapshot is
taken before ``save`` returns, and a commit never takes a shard an
earlier fleet left for the same step.
"""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs.registry import get_config as jax_get_config
from repro.models import model as jlm
from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint import codec
from repro_torch.configs.registry import get_config
from repro_torch.models import model as tlm
from repro_torch.optim import adam as tadam

BF16 = ml_dtypes.bfloat16


# --- conversions (test side only: the port never touches numpy's bf16) ----


def to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def raw(x) -> tuple:
    """(dtype name, shape, bytes) of a numpy array, jax array or tensor."""
    if isinstance(x, torch.Tensor):
        return ckpt.dtype_name(x.dtype), tuple(x.shape), ckpt._byte_view(x.contiguous()).tobytes()
    a = np.asarray(x)
    return a.dtype.name, a.shape, a.tobytes()


def assert_same(a_tree, b_tree):
    a, _ = jax.tree_util.tree_flatten_with_path(a_tree)
    b, _ = jax.tree_util.tree_flatten_with_path(
        b_tree, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert [jax.tree_util.keystr(k) for k, _ in a] == [jax.tree_util.keystr(k) for k, _ in b]
    for (k, x), (_, y) in zip(a, b, strict=True):
        assert raw(x) == raw(y), jax.tree_util.keystr(k)


def mixed_tree(seed=0):
    """numpy leaves of every dtype the format carries, 0-d ones and a
    list among them; bf16 made from bits."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**16, size=(6, 5), dtype=np.uint16)
    bits[(bits & 0x7F80) == 0x7F80] &= 0x3FFF  # no NaN/inf patterns
    return {
        "params": {
            "w": rng.standard_normal((6, 4)).astype(np.float32),
            "b16": bits.view(BF16),
            "ids": rng.integers(-5, 5, size=(3, 8), dtype=np.int32),
            "layers": [{"scale": np.float32(rng.standard_normal())},
                       {"scale": np.float32(2.5), "z": rng.standard_normal(7).astype(np.float32)}],
        },
        "count": np.int32(7),
        "a": rng.standard_normal((2, 3, 4)).astype(np.float32),
    }


def torch_tree(tree):
    return jax.tree.map(to_torch, tree)


def jax_state(arch, seed=0):
    """{"params", "m", "v"} of a reduced arch in the JAX layout (numpy),
    m and v random fp32."""
    cfg = jax_get_config(arch).reduced()
    params = jax.tree.map(np.asarray, jlm.init_params(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def moment(x):
        return rng.standard_normal(x.shape).astype(np.float32)

    return {"params": params, "m": jax.tree.map(moment, params), "v": jax.tree.map(moment, params)}


# --- the codec ------------------------------------------------------------


def _gen(rng, depth=0):
    kinds = ["int", "str", "bin"] + (["list", "dict", "tensor"] if depth < 3 else [])
    kind = kinds[rng.integers(len(kinds))]
    if kind == "int":
        return int(rng.choice([0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
                               2**63, int(rng.integers(0, 2**40))]))
    if kind == "str":
        n = int(rng.choice([0, 1, 31, 32, 255, 256, 65536]))
        return "".join(rng.choice(list("ab'[]é")) for _ in range(n))
    if kind == "bin":
        n = int(rng.choice([0, 1, 255, 256, 65535, 65536]))
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == "list":
        return [_gen(rng, depth + 1) for _ in range(int(rng.choice([0, 1, 15, 16, 17])))]
    if kind == "dict":
        return {f"['k{i}']" + "x" * int(rng.integers(40)): _gen(rng, depth + 1)
                for i in range(int(rng.choice([0, 1, 15, 16, 17])))}
    # an encoded leaf, as the checkpoint holds it
    dt = [torch.float32, torch.bfloat16, torch.int32][int(rng.integers(3))]
    shape = [(), (0,), (3,), (64,), (8, 8), (16385,)][int(rng.integers(6))]
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dt)
    return {**ckpt._encode(t), "index": [[0, d] for d in shape]}


def _as_bytes(obj):
    """``obj`` with its memoryviews as bytes, dict order kept (msgpack's input)."""
    if isinstance(obj, dict):
        return {k: _as_bytes(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_as_bytes(v) for v in obj]
    return bytes(obj) if isinstance(obj, memoryview) else obj


@pytest.mark.parametrize("seed", range(8))
def test_codec_is_msgpack_byte_for_byte(seed):
    """``packb`` gives ``msgpack.packb``'s bytes, ``dump`` the same bytes
    to a file, and ``unpackb`` reads what msgpack wrote: over trees of
    ints, str, bin and encoded tensors across every header border."""
    obj = _gen(np.random.default_rng(seed))
    ours = codec.packb(obj)
    ref = msgpack.packb(_as_bytes(obj))
    assert ours == ref
    assert codec.unpackb(ref) == msgpack.unpackb(ref, strict_map_key=False)


@pytest.mark.parametrize("n", [0, 1, 31, 32, 255, 256, 65535, 65536, 70000])
def test_codec_header_borders(n, tmp_path):
    for obj in (b"\x01" * n, "e" * n, list(range(min(n, 70000))), {str(i): i for i in range(n)},
                n, 2**32 + n):
        ref = msgpack.packb(obj)
        assert codec.packb(obj) == ref
        with open(tmp_path / "x", "wb") as f:
            assert codec.dump(obj, f) == len(ref)
        assert (tmp_path / "x").read_bytes() == ref
        assert codec.unpackb(ref) == msgpack.unpackb(ref, strict_map_key=False)


def test_codec_refuses_what_the_format_never_holds():
    for bad in (1.5, None, True, object()):
        with pytest.raises(TypeError):
            codec.packb({"x": bad})
    with pytest.raises(ValueError, match="extra bytes"):
        codec.unpackb(msgpack.packb(1) + b"\x00")


# --- flattening and the JAX layout ---------------------------------------


def test_flatten_keys_are_keystr():
    tree = mixed_tree()
    ours = [k for k, _ in ckpt._flatten(torch_tree(tree))[0]]
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    assert ours == [jax.tree_util.keystr(k) for k, _ in flat]
    toy = {"params": {"b": np.ones(1), "a": [np.ones(1), {"z": np.ones(1)}]}}
    assert [k for k, _ in ckpt._flatten(toy)[0]] == [
        "['params']['a'][0]", "['params']['a'][1]['z']", "['params']['b']"]


def to_jax(cfg, port):
    """The port's params in the JAX layout as host tensors, each stack
    made by a checkpoint's snapshot, a layer at a time on the host."""
    items, like = ckpt._flatten(tlm.jax_layout(cfg, port, ckpt.Stacked))
    return ckpt._unflatten(like, [t for _, t in ckpt._snapshot(items)])


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "jamba-1.5-large-398b", "whisper-large-v3"])
def test_jax_layout_inverts_params_from_jax(arch):
    """``jax_layout`` gives back the JAX tree bit for bit (stacked period
    slots, the encdec stacks), for params and an Adam moment tree,
    stacked by ``torch.stack`` or by a checkpoint's snapshot; its
    ``like_of`` has the JAX tree's keys, shapes and dtypes;
    ``params_from_jax`` takes torch host tensors as it takes numpy."""
    cfg = get_config(arch).reduced()
    state = jax_state(arch)
    for part in ("params", "m"):
        port = tlm.params_from_jax(cfg, state[part], device="cpu")
        assert_same(state[part], to_jax(cfg, port))
        assert_same(state[part], tlm.jax_layout(cfg, port, torch.stack))
        like = ckpt.like_of(tlm.jax_layout(cfg, port, ckpt.Stacked))
        flat_like, _ = jax.tree_util.tree_flatten_with_path(
            like, is_leaf=lambda x: isinstance(x, torch.Tensor))
        flat_ref, _ = jax.tree_util.tree_flatten_with_path(state[part])
        assert [(jax.tree_util.keystr(k), tuple(v.shape), ckpt.dtype_name(v.dtype))
                for k, v in flat_like] == [(jax.tree_util.keystr(k), v.shape, v.dtype.name)
                                           for k, v in flat_ref]
        again = tlm.params_from_jax(cfg, torch_tree(state[part]), device="cpu")
        assert_same(to_jax(cfg, port), to_jax(cfg, again))


def test_adam_restored_state_step():
    m = {"w": torch.ones(3)}
    st = tadam.restored(7, m, {"w": torch.zeros(3)})
    assert st.step.dtype == torch.int32 and int(st.step) == 7 and st.m is m


# --- both packages read each other's checkpoints --------------------------


def test_port_save_restores_in_jax_and_back(tmp_path):
    tree = mixed_tree()
    d = str(tmp_path)
    ckpt.save(d, 3, torch_tree(tree))
    got = jckpt.restore(d, 3, tree)
    assert_same(tree, jax.tree.map(np.asarray, got))
    assert_same(tree, ckpt.restore(d, 3, ckpt.like_of(torch_tree(tree))))


def test_jax_save_restores_in_port(tmp_path):
    tree = mixed_tree(1)
    d = str(tmp_path)
    jckpt.save(d, 5, tree)
    assert ckpt.list_steps(d) == [5] and ckpt.latest_step(d) == 5
    got = ckpt.restore(d, 5, torch_tree(tree))
    assert_same(tree, got)


def test_monolithic_files_are_byte_identical(tmp_path):
    tree = mixed_tree(2)
    jckpt.save(str(tmp_path / "j"), 1, tree)
    ckpt.save(str(tmp_path / "t"), 1, torch_tree(tree))
    for name in ("manifest.json", "shard_0.msgpack", "COMMITTED"):
        assert (tmp_path / "j" / "step_00000001" / name).read_bytes() == \
            (tmp_path / "t" / "step_00000001" / name).read_bytes()


def _save_sharded_all(mod, d, step, tree, ranks):
    for r in sorted(ranks, reverse=True):  # the leader last: its commit finds every shard
        mod.save_sharded(d, step, tree, rank=r, ranks=ranks, commit_timeout_s=5)


@pytest.mark.parametrize("ranks", [[0, 1], [0, 1, 2, 3], [0, 2, 3]], ids=str)
def test_sharded_saves_cross_both_ways(ranks, tmp_path):
    """Each package's sharded save restores in the other bit for bit; the
    manifests and every shard file are byte-identical."""
    tree = mixed_tree(3)
    _save_sharded_all(ckpt, str(tmp_path / "t"), 4, torch_tree(tree), ranks)
    _save_sharded_all(jckpt, str(tmp_path / "j"), 4, tree, ranks)
    for r in ranks:
        name = f"step_00000004/shard_{r}.msgpack"
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    assert (tmp_path / "t/step_00000004/manifest.json").read_bytes() == \
        (tmp_path / "j/step_00000004/manifest.json").read_bytes()
    assert_same(tree, jax.tree.map(np.asarray, jckpt.restore(str(tmp_path / "t"), 4, tree)))
    assert_same(tree, ckpt.restore(str(tmp_path / "j"), 4, ckpt.like_of(torch_tree(tree))))


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("ranks", [[0, 1], [0, 2, 3]], ids=str)
def test_shard_plan_and_manifest_equal_jax(arch, ranks, tmp_path):
    """On the reduced model's {params, m, v} tree, the port's (made from
    its own per-layer params through the JAX layout): the same plan, the
    same manifest bytes, a valid partition."""
    cfg = get_config(arch).reduced()
    state = jax_state(arch)
    port = {k: to_jax(cfg, tlm.params_from_jax(cfg, v, device="cpu"))
            for k, v in state.items()}
    t_items, _ = ckpt._flatten(port)
    j_items = [(jax.tree_util.keystr(k), v)
               for k, v in jax.tree_util.tree_flatten_with_path(state)[0]]
    tplan, jplan = ckpt.make_shard_plan(t_items, ranks), jckpt.make_shard_plan(j_items, ranks)
    assert {k: [(p.shard, p.index) for p in v] for k, v in tplan.items()} == \
        {k: [(p.shard, p.index) for p in v] for k, v in jplan.items()}
    ckpt.validate_plan(tplan, {k: v.shape for k, v in t_items})
    ckpt.write_sharded_manifest(str(tmp_path / "t"), 2, t_items, plan=tplan, ranks=ranks)
    jckpt.write_sharded_manifest(str(tmp_path / "j"), 2, j_items, plan=jplan, ranks=ranks)
    assert (tmp_path / "t/step_00000002/manifest.json").read_bytes() == \
        (tmp_path / "j/step_00000002/manifest.json").read_bytes()


# --- crash safety and the saver ---------------------------------------------


def _torn(d, ranks=(0, 1, 2)):
    """Shards 0 and 1 and the manifest of step 7 on disk, shard 2 and
    COMMITTED not: a writer killed mid-save."""
    items, _ = ckpt._flatten(torch_tree({
        "w": np.arange(24, dtype=np.float32).reshape(6, 4),
        "b": np.arange(6, dtype=np.float32),
        "scale": np.float32(2.5),
    }))
    plan = ckpt.make_shard_plan(items, ranks)
    for r in (0, 1):
        ckpt.write_shard(d, 7, items, rank=r, plan=plan)
    ckpt.write_sharded_manifest(d, 7, items, plan=plan, ranks=ranks)
    return items, plan


def test_torn_step_is_invisible_and_missing_shard_is_an_error(tmp_path):
    d = str(tmp_path)
    items, plan = _torn(d)
    like = {k[2:-2]: torch.zeros(v.shape) for k, v in items}
    ckpt.save(d, 5, like)
    assert ckpt.list_steps(d) == [5] and ckpt.latest_step(d) == 5
    assert jckpt.list_steps(d) == [5]
    with pytest.raises(TimeoutError, match="missing shards"):
        ckpt.commit_sharded(d, 7, timeout_s=0.2)
    with pytest.raises(ckpt.MissingShardError, match="shard_2.msgpack"):
        ckpt.restore(d, 7, like)
    got = ckpt.restore(d, 7, {"scale": like["scale"]})  # its only piece is on shard 0
    assert float(got["scale"]) == 2.5
    ckpt.write_shard(d, 7, items, rank=2, plan=plan)
    ckpt.commit_sharded(d, 7, timeout_s=5)
    assert ckpt.latest_step(d) == 7
    full = ckpt.restore(d, 7, like)
    assert torch.equal(full["w"], torch.arange(24.0).reshape(6, 4))


def test_partial_restore_opens_only_the_needed_shards(tmp_path, monkeypatch):
    d = str(tmp_path)
    items, plan = _torn(d)
    opened = []
    real = ckpt._read_file
    monkeypatch.setattr(ckpt, "_read_file", lambda p: opened.append(os.path.basename(p))
                        or real(p))
    ckpt.restore(d, 7, {"scale": torch.zeros(())})
    owner = plan["['scale']"][0].shard
    assert opened == [f"shard_{owner}.msgpack"]


def test_commit_waits_for_a_shard_of_the_manifests_plan(tmp_path):
    """A shard an earlier fleet left for the same step (another plan) is
    not taken: the commit waits until its rank rewrites it."""
    d = str(tmp_path)
    items, _ = ckpt._flatten({"w": torch.arange(24.0).reshape(6, 4)})
    old = ckpt.make_shard_plan(items, [0, 1, 2])
    for r in (0, 1, 2):
        ckpt.write_shard(d, 9, items, rank=r, plan=old)
    new = ckpt.make_shard_plan(items, [0, 1])
    ckpt.write_shard(d, 9, items, rank=0, plan=new)
    ckpt.write_sharded_manifest(d, 9, items, plan=new, ranks=[0, 1])
    with pytest.raises(TimeoutError, match=r"ranks \[1\]"):
        ckpt.commit_sharded(d, 9, timeout_s=0.2)
    ckpt.write_shard(d, 9, items, rank=1, plan=new)
    ckpt.commit_sharded(d, 9, timeout_s=5)
    assert torch.equal(ckpt.restore(d, 9, {"w": torch.zeros(6, 4)})["w"],
                       torch.arange(24.0).reshape(6, 4))


def test_keep_collects_old_steps(tmp_path):
    d = str(tmp_path)
    for s in range(1, 6):
        ckpt.save(d, s, {"x": torch.full((2,), float(s))}, keep=2)
    assert ckpt.list_steps(d) == [4, 5]
    saver = ckpt.Saver(d, keep=3)
    for s in (6, 7, 8, 9):
        saver.save(s, {"x": torch.full((2,), float(s))})
    saver.wait()
    assert saver.last_error is None and ckpt.list_steps(d) == [7, 8, 9]


def test_saver_snapshot_is_taken_before_save_returns(tmp_path):
    """An in-place write to the tensors right after ``save`` returns (a
    train step's Adam update) does not reach the file; a ``Stacked`` leaf
    lands as the stack of its parts."""
    d = str(tmp_path)
    w = torch.arange(6.0)
    layers = [torch.full((3,), float(i)) for i in range(4)]
    saver = ckpt.Saver(d)
    saver.save(1, {"w": w, "s": ckpt.Stacked(layers)})
    w.add_(100.0)
    for t in layers:
        t.mul_(-1)
    saver.wait()
    got = ckpt.restore(d, 1, {"w": torch.zeros(6), "s": torch.zeros(4, 3)})
    assert torch.equal(got["w"], torch.arange(6.0))
    assert torch.equal(got["s"], torch.arange(4.0)[:, None].expand(4, 3))
    st = saver.last_stats
    assert st["bytes"] == (6 + 12) * 4 and st["write_s"] >= 0
    assert 0 <= st["alloc_s"] + st["copy_s"] <= st["snapshot_s"]


def test_saver_wait_idempotent_and_errors_surface(tmp_path):
    saver = ckpt.Saver(str(tmp_path))
    saver.wait()
    saver.save(1, {"x": torch.ones(2)})
    saver.wait()
    saver.wait()
    assert ckpt.latest_step(str(tmp_path)) == 1 and saver.last_error is None
    (tmp_path / "blocker").write_text("a file where the checkpoint dir should be")
    bad = ckpt.Saver(str(tmp_path / "blocker"))
    bad.save(1, {"x": torch.ones(2)})
    bad.wait()
    assert isinstance(bad.last_error, OSError)


def test_restore_casts_to_like_and_moves_to_device(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, {"x": torch.arange(4.0)})
    got = ckpt.restore(d, 1, {"x": torch.empty(4, dtype=torch.bfloat16, device="meta")},
                       device="cpu")
    assert got["x"].dtype == torch.bfloat16 and got["x"].device.type == "cpu"
    with pytest.raises(KeyError):
        ckpt.restore(d, 1, {"y": torch.zeros(4)})


def test_jax_bf16_leaf_restores_without_ml_dtypes_in_the_port(tmp_path):
    """JAX writes bf16 as ``"bfloat16"``; the port reads it through a byte
    view of a ``torch.bfloat16`` tensor."""
    x = jnp.asarray(np.linspace(-3, 3, 10, dtype=np.float32), jnp.bfloat16)
    assert str(np.asarray(x).dtype) == "bfloat16"
    jckpt.save(str(tmp_path), 2, {"x": x})
    meta = json.loads((tmp_path / "step_00000002" / "manifest.json").read_text())
    assert meta["keys"] == ["['x']"]
    got = ckpt.restore(str(tmp_path), 2, {"x": torch.empty(10, dtype=torch.bfloat16)})
    assert raw(got["x"]) == raw(np.asarray(x))
