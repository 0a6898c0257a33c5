"""The encoder-decoder and VLM families under a global batch the data axes
do not divide, against the JAX package's one-device step, on the CPU.

The reference's ``fit_spec`` moves ``data`` to the tokens' sequence (and
``pod`` stays on the batch where it divides it). whisper's frames keep
their rows' split and are whole past them on every rank of the sequence
group: the encoder runs alike there, the cross-attention's K/V gradient
is summed over the group before its sites' backward, and the alike leaves
(encoder, ``enc_norm``, cross k/v) are summed over the batch axes alone.
paligemma's patches take the data axes on their patch dim, so a rank's
sequence is its patch block and its token block, and causal attention
masks by position vectors. The reduced configs in fp32, the JAX package's
params from ``PRNGKey(0)``, 3 steps (dense, then two at
``paper_default(0.8)`` with ``use_pallas``, lr 5e-5) through
``make_train_step`` (``torch_mesh_ranks.seq_train``): the losses and every
final param within 1e-5 of the JAX steps, and the kept channels of every
site in every sparse step equal to the JAX step's (the encoder's sites and
``cross/k``, ``cross/v`` among them):

* whisper on 2x1 at batch 1 and 3, 16 positions (8 tokens a rank, the 32
  frames alike on both), on ``pod x data x model`` 2x2x1 at batch 2 (a row
  a pod: the alike leaves summed over ``pod``), and at batch 3 and 15
  positions on 2x1 (``data`` divides neither: no sum over ``data``);
* paligemma on 2x1 at batch 1 and 3 (4 patches and 8 tokens a rank: rank
  1's patch queries at positions 4-7 must not see rank 0's tokens at
  8-15), on 2x2 at batch 1 (its one KV head across ``model`` too) and on
  2x2x1 at batch 2.

Each rank's ``matmul`` calls equal the launch table's. Beside them:
``masked_attention``'s position vectors against its ``q_offset`` form and
against the one-device attention, the rank's blocks against the JAX
package's fitted specs, and the refusal of a layout that splits the
tokens' sequence but not the patches. The two mesh sizes run in one spawn
each (one torch thread a rank, a 120-s timeout).
"""
import argparse

import jax
import jax.numpy as jnp
import pytest
import torch
import torch_mesh_jax as ref
import torch_mesh_ranks as ranks

from repro.dist import sharding as jshd
from repro_torch.configs.registry import get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as ttrain
from repro_torch.models import layers
from repro_torch.models import model as tlm

LR = 5e-5
TIMEOUT_S = 120
W, P = "whisper-large-v3", "paligemma-3b"
# name -> (arch, batch, seq, (pod, data, model), rank 0's (rows, positions, patches))
CASES = {
    "encdec-b1-2x1": (W, 1, 16, (1, 2, 1), ((0, 1), (0, 8), (0, 0))),
    "encdec-b3-2x1": (W, 3, 16, (1, 2, 1), ((0, 3), (0, 8), (0, 0))),
    "encdec-pod-b2-2x2x1": (W, 2, 16, (2, 2, 1), ((0, 1), (0, 8), (0, 0))),
    "encdec-replicated-b3-s15-2x1": (W, 3, 15, (1, 2, 1), ((0, 3), (0, 15), (0, 0))),
    "vlm-b1-2x1": (P, 1, 16, (1, 2, 1), ((0, 1), (0, 8), (0, 4))),
    "vlm-b3-2x1": (P, 3, 16, (1, 2, 1), ((0, 3), (0, 8), (0, 4))),
    "vlm-b1-2x2": (P, 1, 16, (1, 2, 2), ((0, 1), (0, 8), (0, 4))),
    "vlm-pod-b2-2x2x1": (P, 2, 16, (2, 2, 1), ((0, 1), (0, 8), (0, 4))),
}


@pytest.fixture(scope="module")
def models():
    """``(arch, batch, seq) -> (JAX config, init, batches)``."""
    out, inits = {}, {}
    for arch, b, s, _, _ in CASES.values():
        if arch not in inits:
            jcfg = ref.config(arch)
            inits[arch] = (jcfg, ref.init(jcfg))
        if (arch, b, s) not in out:
            jcfg, tree = inits[arch]
            out[arch, b, s] = (jcfg, tree, ref.batches(jcfg, b, s))
    return out


@pytest.fixture(scope="module")
def jax_runs(models):
    return {key: ref.train(jcfg, tree, data, LR) for key, (jcfg, tree, data) in models.items()}


@pytest.fixture(scope="module")
def port_runs(models):
    """Every case's rank-0 result, one spawn of the cases of each world size."""
    out = {}
    for world, dm in ((2, (2, 1)), (4, (2, 2))):
        names = [n for n, c in CASES.items() if c[3][0] * c[3][1] * c[3][2] == world]
        calls = []
        for n in names:
            arch, b, s, shape, _ = CASES[n]
            _, tree, data = models[arch, b, s]
            calls.append((ranks.seq_train, (shape, arch, tree, {}, data, LR)))
        got = tmesh.run_on_mesh(ranks.in_turn, *dm, "cpu", calls, timeout_s=TIMEOUT_S)
        out.update(zip(names, got, strict=True))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_seq_split_family_steps_match_the_jax_one_device_steps(port_runs, jax_runs, name):
    got, want = port_runs[name], jax_runs[CASES[name][:3]]
    ref.assert_matches(got, want, name)
    assert got["matmul_calls"] == got["matmul_table"]
    assert all(n > 0 for n in got["matmul_table"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_rank_holds_its_block_and_sums_the_cross_kv_gradient(port_runs, name):
    """Rank 0's rows, positions and patches are the fitted specs' blocks;
    the sequence split's collectives run exactly where it splits the
    sequence, and under it whisper's cross K/V gradient is summed over the
    group once a decoder layer a step (2 layers), paligemma's never."""
    arch, _, s, _, (rows, seq, patches) = CASES[name]
    got = port_runs[name]
    assert (tuple(got["rows"]), tuple(got["seq"]), tuple(got["patches"])) == (rows, seq, patches)
    split = seq != (0, s)
    calls = [c for c, _ in got["seq_collectives"]]
    assert len(set(calls)) == 1 and (calls[0] > 0) == split, got["seq_collectives"]
    kv_sums = {c for c, _ in got["kv_sum_collectives"]}
    assert kv_sums == {2 if split and arch == W else 0}, got["kv_sum_collectives"]
    # whisper's frames are whole past their rows (data on their 32 positions);
    # paligemma's patches split with its tokens
    assert [w.split(":")[0] for w in got["whole"]] == (["frames"] if arch == W else [])


# ----------------------------------------------------------------------
# attention by position vectors
# ----------------------------------------------------------------------


def _qkv(b, s, t, h, kv, d, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, s, h, d, generator=g), torch.randn(b, t, kv, d, generator=g),
            torch.randn(b, t, kv, d, generator=g))


@pytest.mark.parametrize("q0, s, chunk", [(0, 8, 1024), (8, 8, 1024), (4, 12, 5), (16, 8, 3)])
def test_position_vectors_equal_the_offset_form_on_one_run(q0, s, chunk):
    """Where a rank's positions are one run, the vector form masks what
    ``q_offset`` masks: the same bits."""
    q, k, v = _qkv(2, s, 24, 4, 2, 16)
    want = layers.masked_attention(q, k, v, q_chunk=chunk, q_offset=q0)
    got = layers.masked_attention(q, k, v, q_chunk=chunk, q_pos=torch.arange(q0, q0 + s),
                                  kv_pos=torch.arange(24))
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [2, 4])
def test_patch_and_token_blocks_attend_as_the_one_device_sequence(n):
    """A VLM rank's queries (its patch block, then its token block) over
    the group's gathered K/V in rank order, masked by the layout's
    positions, give the one-device attention's rows at those positions."""
    cfg = get_config(P).reduced()  # 8 patches
    n_p, s = cfg.n_patches, 16
    q, k, v = _qkv(1, n_p + s, n_p + s, 4, 1, 8, seed=1)
    want = layers.masked_attention(q, k, v)
    ms = {"data": n, "model": 1}
    blocks = [tlm.batch_layout(cfg, tmesh.shape_mesh(ms, r), 1, s) for r in range(n)]
    order = blocks[0].group_positions("cpu")
    assert sorted(order.tolist()) == list(range(n_p + s))
    for j, lay in enumerate(blocks):  # rank j is the j-th block of the gathered order
        pos = lay.positions("cpu")
        assert torch.equal(pos, order[j * len(pos):(j + 1) * len(pos)])
        got = layers.masked_attention(q[:, pos], k[:, order], v[:, order], q_pos=pos,
                                      kv_pos=order)
        torch.testing.assert_close(got, want[:, pos], rtol=0, atol=1e-6)


# ----------------------------------------------------------------------
# the layouts against the JAX package's fitted specs
# ----------------------------------------------------------------------

LAYOUTS = [
    (W, {"data": 2, "model": 1}, 1, 16),
    (W, {"pod": 2, "data": 2, "model": 1}, 2, 16),
    (W, {"data": 2, "model": 1}, 3, 15),
    (P, {"data": 2, "model": 1}, 3, 16),
    (P, {"data": 2, "model": 2}, 1, 16),
    (P, {"pod": 2, "data": 2, "model": 1}, 2, 16),
    (P, {"data": 2, "model": 1}, 3, 15),
    (W, {"data": 16, "model": 16}, 8, 4096),
    (W, {"pod": 2, "data": 16, "model": 16}, 8, 4096),
    (P, {"data": 16, "model": 16}, 8, 4096),
    (P, {"pod": 2, "data": 16, "model": 16}, 8, 4096),
]


def _block(spec, dim, d, ms, rank):
    coord = {"pod": rank // ms["model"] // ms["data"], "data": rank // ms["model"] % ms["data"],
             "model": rank % ms["model"]}
    e = spec[dim] if dim < len(spec) else None
    axes = () if e is None else e if isinstance(e, tuple) else (e,)
    n, b = 1, 0
    for a in axes:
        n, b = n * ms[a], b * ms[a] + coord[a]
    return (b * d // n, (b + 1) * d // n), axes


@pytest.mark.parametrize("arch, ms, b, s", LAYOUTS,
                         ids=[f"{a[:7]}-{m}-{b}x{s}" for a, m, b, s in LAYOUTS])
def test_frontend_blocks_are_the_jax_fitted_specs(arch, ms, b, s):
    """Full-size frames and patches at the production meshes' cells and
    reduced ones at the small meshes: every rank's patch block is the JAX
    ``batch_shardings`` block of the patch dim, and the frames (or the
    patches of a replicated batch) are listed ``whole`` exactly where
    that spec puts a data axis past their rows."""
    cfg = get_config(arch) if ms["data"] == 16 else get_config(arch).reduced()
    name, n = ("frames", cfg.enc_seq) if arch == W else ("patches", cfg.n_patches)
    am = jax.sharding.AbstractMesh(tuple(ms.values()), tuple(ms))
    shape = (b, n, cfg.d_model)
    spec = jshd.batch_shardings(am, {"x": jax.ShapeDtypeStruct(shape, jnp.float32)})["x"].spec
    world = ms.get("pod", 1) * ms["data"] * ms["model"]
    for rank in range(0, world, max(1, world // 8)):
        lay = tlm.batch_layout(cfg, tmesh.shape_mesh(ms, rank), b, s)
        rows, _ = _block(spec, 0, b, ms, rank)
        assert lay.rows == rows
        pblk, paxes = _block(spec, 1, n, ms, rank)
        _, daxes = _block(spec, 2, cfg.d_model, ms, rank)
        if arch == P and lay.seq_split:
            assert lay.patches == pblk and paxes == lay.seq_axes, (rank, spec)
            assert lay.whole == ()
        else:
            assert lay.patches == ((0, n) if arch == P else (0, 0))
            assert bool(lay.whole) == bool(paxes or daxes), (rank, spec, lay.whole)


def test_a_layout_that_splits_the_tokens_but_not_the_patches_is_refused():
    """Reduced paligemma at ``--data-mesh 3 --global-batch 1 --seq-len
    24``: the tokens' sequence splits over ``data`` (8 a rank), but 3
    divides neither the 8 patches nor their width of 128. The layout, the
    training CLI's check and the CLI itself refuse it, naming ROADMAP
    Queue 1 item 5 sub-item 4; a fleet on a mesh is no longer refused."""
    cfg = get_config(P).reduced()
    with pytest.raises(NotImplementedError, match="sub-item 4"):
        tlm.batch_layout(cfg, tmesh.shape_mesh({"data": 3, "model": 1}), 1, 24)
    args = ttrain.build_parser().parse_args(
        ["--device", "cpu", "--reduced", "--arch", P, "--data-mesh", "3", "--global-batch", "1",
         "--seq-len", "24", "--steps", "1"])
    with pytest.raises(NotImplementedError, match="Queue 1 item 5 sub-item 4"):
        ttrain.run(args)
    for arch in (W, P):  # the frames and patches under such a batch are no longer refused
        ok = argparse.Namespace(data_mesh=2, model_mesh=1, world_size=1, global_batch=1,
                                seq_len=16)
        ttrain._refuse_unported(ok, get_config(arch).reduced())
        assert ttrain._refuse_unported(argparse.Namespace(**dict(vars(ok), world_size=2)),
                                       get_config(arch).reduced()) is None
