"""Training on a mesh whose data axes do not divide the global batch,
against the JAX package's one-device step, on the CPU.

Where the data axes do not divide the batch, the reference's ``fit_spec``
moves ``data`` to the sequence dim (``pod`` stays on the batch where it
divides it) or, where it divides neither, replicates it; the port's rank
steps its block of that fitted spec (``models/model.py::batch_layout``).
The reduced qwen2.5-3b and mamba2 configs in fp32, the JAX package's
params from ``PRNGKey(0)``, 3 steps (dense, then two at
``paper_default(0.8)`` with ``use_pallas``, lr 5e-5) through
``make_train_step`` (the rank body ``torch_mesh_ranks.seq_train``): the
losses and every final param within 1e-5 of the JAX steps, and the kept
channels of every sparse step equal to the JAX step's at every site:

* qwen2.5-3b on 2x1 at batch 1 and 3 and on 2x2 at batch 1 (``data`` on
  the sequence, 8 positions a rank, the K/V gathered over ``data``);
* on a ``pod x data x model`` mesh of 2x2x1 at batch 2 (``pod`` on the
  batch, a row a pod; ``data`` on the sequence);
* at batch 3 and 15 positions on 2x1 (``data`` divides neither: both
  ranks step the whole batch, and no gradient is summed over ``data``),
  and at batch 2 and 15 positions on 2x2x1 (``pod`` on the batch, ``data``
  nowhere: the step's data group is ``pod`` alone);
* mamba2 on 2x1 at batch 1 with a block of one 16-token chunk a rank,
  and of two (20 positions: a whole chunk and one padded at the block's
  end, whose padding must not move the state passed on); the conv's halo
  and the carried state pass between the ranks.

Each rank's ``matmul`` calls equal the launch table's, and the sequence
split runs its collectives where it splits the sequence, and none where
it does not. The two mesh sizes run in one spawn each (one torch thread a
rank, a 120-s timeout).
"""
import jax
import jax.numpy as jnp
import pytest
import torch_mesh_jax as ref
import torch_mesh_ranks as ranks

from repro.dist import sharding as jshd
from repro_torch.configs.registry import get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model as tlm

LR = 5e-5
TIMEOUT_S = 120
# name -> (arch, batch, seq, (pod, data, model), the rank's (rows, positions) on rank 0)
CASES = {
    "dense-b1-2x1": ("qwen2.5-3b", 1, 16, (1, 2, 1), ((0, 1), (0, 8))),
    "dense-b3-2x1": ("qwen2.5-3b", 3, 16, (1, 2, 1), ((0, 3), (0, 8))),
    "dense-b1-2x2": ("qwen2.5-3b", 1, 16, (1, 2, 2), ((0, 1), (0, 8))),
    "pod-b2-2x2x1": ("qwen2.5-3b", 2, 16, (2, 2, 1), ((0, 1), (0, 8))),
    "replicated-b3-s15-2x1": ("qwen2.5-3b", 3, 15, (1, 2, 1), ((0, 3), (0, 15))),
    "pod-replicated-b2-s15-2x2x1": ("qwen2.5-3b", 2, 15, (2, 2, 1), ((0, 1), (0, 15))),
    "ssm-one-chunk-2x1": ("mamba2-1.3b", 1, 32, (1, 2, 1), ((0, 1), (0, 16))),
    "ssm-two-chunks-padded-2x1": ("mamba2-1.3b", 1, 40, (1, 2, 1), ((0, 1), (0, 20))),
}


@pytest.fixture(scope="module")
def models():
    """``(arch, batch, seq) -> (JAX config, init, batches)``: the cases of
    one arch and shape share them and their JAX run."""
    out = {}
    for arch, b, s, _, _ in CASES.values():
        if (arch, b, s) not in out:
            jcfg = ref.config(arch)
            out[arch, b, s] = (jcfg, ref.init(jcfg), ref.batches(jcfg, b, s))
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
def test_seq_split_steps_match_the_jax_one_device_steps(port_runs, jax_runs, name):
    got, want = port_runs[name], jax_runs[CASES[name][:3]]
    ref.assert_matches(got, want, name)
    assert got["matmul_calls"] == got["matmul_table"]
    assert all(n > 0 for n in got["matmul_table"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_rank_holds_the_fitted_specs_block(port_runs, name):
    """Rank 0's rows and positions are the fitted batch spec's block, and
    the sequence split's collectives run exactly where it splits the
    sequence (forward gathers and their backward all-reduces, every step
    alike)."""
    got = port_runs[name]
    rows, seq = CASES[name][4]
    assert (tuple(got["rows"]), tuple(got["seq"])) == (rows, seq)
    split = seq != (0, CASES[name][2])
    calls = [c for c, _ in got["seq_collectives"]]
    assert len(set(calls)) == 1
    assert (calls[0] > 0) == split, got["seq_collectives"]


# (mesh shape, batch, seq): the fitted spec's placement of the data axes
LAYOUTS = [
    ({"pod": 2, "data": 2, "model": 1}, 2, 16),  # pod on the batch, data on the sequence
    ({"pod": 2, "data": 2, "model": 1}, 4, 16),  # both on the batch
    ({"pod": 2, "data": 2, "model": 1}, 3, 15),  # neither: replicated
    ({"data": 2, "model": 1}, 3, 16),  # data on the sequence
    ({"data": 2, "model": 1}, 4, 16),  # data on the batch
    ({"data": 2, "model": 1}, 3, 15),  # replicated
    ({"data": 16, "model": 16}, 8, 4096),  # train_tight on one pod
    ({"pod": 2, "data": 16, "model": 16}, 8, 4096),  # and on two
]


def _blocks(spec, shape, ms, rank):
    """The ``[lo, hi)`` of each dim a rank holds under a fitted spec, by
    the spec's own arithmetic (axes pod-major, rank ``r`` at ``(r //
    model // data, r // model % data, r % model)``)."""
    coord = {"pod": rank // ms["model"] // ms["data"], "data": rank // ms["model"] % ms["data"],
             "model": rank % ms["model"]}
    out = []
    for i, d in enumerate(shape):
        axes = () if spec[i] is None else spec[i] if isinstance(spec[i], tuple) else (spec[i],)
        n, b = 1, 0
        for a in axes:
            n, b = n * ms[a], b * ms[a] + coord[a]
        out.append((b * d // n, (b + 1) * d // n))
    return out


@pytest.mark.parametrize("ms, b, s", LAYOUTS, ids=[f"{m}-{b}x{s}" for m, b, s in LAYOUTS])
def test_batch_layout_is_the_jax_fitted_batch_spec(ms, b, s):
    """Every rank's rows and positions are the block the JAX package's
    ``batch_shardings`` gives it, and the step's data group is the axes
    that spec puts on the batch or the sequence."""
    am = jax.sharding.AbstractMesh(tuple(ms.values()), tuple(ms))
    spec = jshd.batch_shardings(am, {"t": jax.ShapeDtypeStruct((b, s), jnp.int32)})["t"].spec
    spec = tuple(spec) + (None,) * (2 - len(spec))
    cfg = get_config("qwen2.5-3b").reduced()
    world = ms.get("pod", 1) * ms["data"] * ms["model"]
    placed = {a for e in spec if e for a in (e if isinstance(e, tuple) else (e,))}
    for rank in range(world):
        layout = tlm.batch_layout(cfg, tmesh.shape_mesh(ms, rank), b, s)
        assert [layout.rows, layout.seq] == _blocks(spec, (b, s), ms, rank), (ms, rank)
        assert set(layout.token_axes) == placed
